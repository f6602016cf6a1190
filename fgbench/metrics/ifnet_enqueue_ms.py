"""Host ms an interpolated frame in the step's ``tpufg.step.ifnet`` span
(RIFE's IFNet: the pad, the three IFBlocks with their resizes and
full-size warps, and sigmoid(mask), as launched)."""

from fgbench.spans import mean_ms


def read(t):
    return mean_ms(t, "tpufg.step.ifnet")
