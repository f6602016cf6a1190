"""RIFE's network's merge kernel, % of its bound (csrc/ifnet_merge.cu, the
residual, the merge, the clamp and the crop: each operand read and written
once): its bytes a pair (``counts_ifnet.kernel_bytes``, from the published
widths at the padded size) times the traced window's pairs at 3.35 TB/s,
over the device time of its launches in the window."""

from fgbench.counts_ifnet import roofline_pct


def read(t):
    return roofline_pct(t, "ifnet_merge")
