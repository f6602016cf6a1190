"""Device ms an input frame of kernels (copies and fills left out)."""

from fgbench.readers import per_frame_ms


def read(t):
    ks = t.kernels()
    return per_frame_ms(t, sum(d for _, _, d in ks)) if ks else None
