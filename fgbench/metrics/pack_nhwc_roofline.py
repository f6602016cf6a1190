"""RIFE's network's pack kernel, % of its bound (csrc/pack_nhwc.cu, the conv
inputs built from f32 planes: each plane read once, each bf16 channel
written once): its bytes a pair (``counts_ifnet.kernel_bytes``, from the
published widths at the padded size) times the traced window's pairs at 3.35
TB/s, over the device time of its launches in the window."""

from fgbench.counts_ifnet import roofline_pct


def read(t):
    return roofline_pct(t, "pack_nhwc")
