"""Kernel launches the traced window recorded a frame pair (a counter of
the device trace's kernel records over the window's pairs): how many
launches RAFT's step, with the unpack, the warps and the pack, takes a
pair.  None where the window ran no ``tpufg.step.raft`` span."""

from fgbench import counts_raft


def read(t):
    n = counts_raft.pairs(t)
    ks = t.kernels()
    if n is None or not ks:
        return None
    return len(ks) / n
