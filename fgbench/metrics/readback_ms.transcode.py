"""Host ms an input frame inside the engine's ``tpufg.readback`` spans
(the copies of the last frame's outputs to the host and the sink)."""

from fgbench.readers import per_frame_ms


def read(t):
    return per_frame_ms(t, t.span_total_s("tpufg.readback"))
