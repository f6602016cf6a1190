"""RAFT's share of the card's bf16 peak while the step runs, %: its FLOPs a
frame pair (``counts_raft.pair_flops`` at the padded size; 3,210.6 GFLOP at
1080p: the correlation, curr's two encoders, 12 updates and the last
mask) times the pairs the traced window ran, over the device time of all
the window's kernels (the whole step: unpack, the network, the warps, the
Lanczos scale and pack) times 989 TFLOP/s.  Copies and the time the device
waits for the source are left out.  None where the window ran no
``tpufg.step.raft`` span."""

from fgbench import counts, counts_raft


def read(t):
    n = counts_raft.pairs(t)
    ks = t.kernels()
    if n is None or not ks:
        return None
    e = t.cell["engine"]
    h, w = counts_raft.padded(e["input_height"], e["input_width"])
    busy_s = sum(d for _, _, d in ks)
    return (counts_raft.pair_flops(h, w) * n
            / (busy_s * counts.PEAK_OPS_PER_S["bf16"]) * 100.0)
