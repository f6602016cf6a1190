"""The Lanczos-3 resample + UNORM8 store + pack of a frame, % of its
bound: the bytes it must move (``counts.lanczos_packed_bytes``, 1080p ->
4K: 66.6 MB at 3.35 TB/s, 0.0199 ms) over the mean device time of the
kernels that do it."""

from fgbench import counts
from fgbench.readers import kernel_share_pct

KERNELS = "lanczos_packed"   # csrc/lanczos_packed.cu: the tile and direct kernels


def read(t):
    e = t.cell["engine"]
    return kernel_share_pct(t, KERNELS, counts.lanczos_packed_bound_s(
        e["input_height"], e["input_width"], e["output_height"],
        e["output_width"], e.get("lanczos_a", 3)))
