"""Kernel launches the traced window recorded a frame pair (a counter of
the device trace's kernel records over the window's pairs): how many
launches RIFE's network, with the unpack and the pack, takes a pair.
None where the window ran no ``tpufg.step.ifnet`` span."""


def read(t):
    ks = t.kernels()
    if t.frames_in < 2 or not ks or not t.spans.get("tpufg.step.ifnet"):
        return None
    return len(ks) / (t.frames_in - 1)
