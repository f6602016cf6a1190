"""Host ms an interpolated frame in the step's ``tpufg.step.head`` span
(the learned head's encoder and trunk, as launched)."""

from fgbench.spans import mean_ms


def read(t):
    return mean_ms(t, "tpufg.step.head")
