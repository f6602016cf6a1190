"""RAFT's correlation lookup kernel, % of its bound (csrc/corr_lookup.cu,
12 lookups a pair: each 1/8 pixel's 10 x 10 f32 patch on each of 4 levels
read, its 324 bf16 channels written): its bytes a pair
(``counts_raft.kernel_bytes``, from the published widths at the padded
size) times the traced window's pairs at 3.35 TB/s, over the device time
of its launches in the window."""

from fgbench.counts_raft import roofline_pct


def read(t):
    return roofline_pct(t, "corr_lookup")
