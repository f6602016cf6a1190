"""Median over every input frame of the window of the time from when it
was due to when the sink held its last output (open-loop mixes)."""

from fgbench.readers import percentile_ms


def read(r):
    return percentile_ms(r, 50)
