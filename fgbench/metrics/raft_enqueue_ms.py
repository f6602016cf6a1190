"""Host ms a frame pair in the step's ``tpufg.step.raft`` span (RAFT's
pad, curr's ``fnet`` and ``cnet``, the all-pairs correlation volume and
its pyramid, as launched)."""

from fgbench.spans import mean_ms


def read(t):
    return mean_ms(t, "tpufg.step.raft")
