"""Ms an input frame's outputs wait for the hand-over: from the end of
its ``tpufg.step`` span to the start of its ``tpufg.readback`` span (the
one-slot pipeline's late hand-over)."""

from fgbench.spans import wait_ms


def read(t):
    return wait_ms(t, "tpufg.step", "tpufg.readback")
