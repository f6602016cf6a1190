"""Ms an input frame waits in the ring: from the end of its
``tpufg.ingest`` span to the start of its ``tpufg.step`` span (the
ring's look-ahead)."""

from fgbench.spans import wait_ms


def read(t):
    return wait_ms(t, "tpufg.ingest", "tpufg.step")
