"""The learned head's stage 2 (r_in -> r_body -> r_head, 3x3 convs at a
quarter of the frame), % of its bound: its operations on the bf16 tensor
cores (``counts.conv_chain_flops``; 17 -> 64 -> 64 -> 5 at 540 x 960:
51.4 GFLOP at 989 TFLOP/s, 0.0519 ms) over the mean device time of the
kernel that does it."""

from fgbench import counts
from fgbench.readers import kernel_share_pct

KERNELS = "conv_chain"       # csrc/conv_chain_mma.cu (bf16), csrc/conv_chain.cu


def read(t):
    e, ck = t.cell["engine"], t.cell.get("checkpoint")
    if not ck:
        return None
    import os
    shapes = counts.checkpoint_shapes(os.path.join(t.cell["root"], ck))
    chans = [shapes["r_in"][1], shapes["r_in"][0], shapes["r_body"][0],
             shapes["r_head"][0]]
    h, w = -(-e["input_height"] // 16) * 4, -(-e["input_width"] // 16) * 4
    return kernel_share_pct(t, KERNELS, counts.conv_chain_bound_s(chans, h, w))
