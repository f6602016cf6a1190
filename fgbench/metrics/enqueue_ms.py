"""Host ms an input frame inside the engine's ``tpufg.step`` spans (the
step's launches; on a host-bound step, its pace)."""

from fgbench.readers import per_frame_ms


def read(t):
    return per_frame_ms(t, t.span_total_s("tpufg.step"))
