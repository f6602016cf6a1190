"""RIFE's network's bias and PReLU kernel, % of its bound (csrc/bias_prelu.cu,
after each of the network's convs: a bf16 element read and written to each
destination): its bytes a pair (``counts_ifnet.kernel_bytes``, from the
published widths at the padded size) times the traced window's pairs at 3.35
TB/s, over the device time of its launches in the window."""

from fgbench.counts_ifnet import roofline_pct


def read(t):
    return roofline_pct(t, "bias_prelu")
