"""Device ms an input frame of host-to-device and device-to-host copies
(the ring's uploads, the outputs' readbacks)."""

from fgbench.readers import per_frame_ms


def read(t):
    cp = t.copies("HtoD", "DtoH")
    return per_frame_ms(t, sum(d for _, _, d in cp)) if cp else None
