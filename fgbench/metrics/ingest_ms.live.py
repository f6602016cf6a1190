"""Host ms an input frame in the ring's ``tpufg.ingest`` span (the copy
into page-locked memory and the queued upload, from the frame's arrival)."""

from fgbench.spans import mean_ms


def read(t):
    return mean_ms(t, "tpufg.ingest")
