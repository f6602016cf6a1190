"""Host ms an interpolated frame in the step's ``tpufg.step.motion`` span
(the scene-cut test, the pyramid or exhaustive search, refine, filter and
MV resize, as launched)."""

from fgbench.spans import mean_ms


def read(t):
    return mean_ms(t, "tpufg.step.motion")
