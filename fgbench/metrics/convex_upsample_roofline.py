"""RAFT's convex upsampling kernel, % of its bound
(csrc/convex_upsample.cu: the bf16 mask of 576 channels and the f32 flow
at 1/8 read, the f32 flow at full size written): its bytes a pair
(``counts_raft.kernel_bytes``, from the published widths at the padded
size) times the traced window's pairs at 3.35 TB/s, over the device time
of its launches in the window."""

from fgbench.counts_raft import roofline_pct


def read(t):
    return roofline_pct(t, "convex_upsample")
