"""RIFE's network's flow and mask accumulation kernel, % of its bound
(csrc/ifnet_accum.cu, each IFBlock's output resized and added into the flow
and mask: the block's output read, the f32 state written and, after the
first block, read): its bytes a pair (``counts_ifnet.kernel_bytes``, from
the published widths at the padded size) times the traced window's pairs at
3.35 TB/s, over the device time of its launches in the window."""

from fgbench.counts_ifnet import roofline_pct


def read(t):
    return roofline_pct(t, "ifnet_accum")
