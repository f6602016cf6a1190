"""RIFE's network's warp kernels, % of its bound (csrc/warp_grid.cu: both
frames' three full-size warps and the Contextnet's eight, the flow, the
source and the output once each): its bytes a pair
(``counts_ifnet.kernel_bytes``, from the published widths at the padded
size) times the traced window's pairs at 3.35 TB/s, over the device time of
its launches in the window."""

from fgbench.counts_ifnet import roofline_pct


def read(t):
    return roofline_pct(t, "warp_grid")
