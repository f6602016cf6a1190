"""RIFE's network's share of the card's bf16 peak while the step runs, %:
its conv and transposed-conv FLOPs a frame pair
(``counts_ifnet.pair_flops`` at the padded size and the cell's
``learned_scale``; 985.4 GFLOP at 4K, s = 0.5) times the pairs the traced
window ran, over the device time of all the window's kernels (the whole
step: unpack, the network, pack) times 989 TFLOP/s, as ``step_mfu`` reads
config 5.  Copies and the time the device waits for the source are left
out.  None where the window ran no ``tpufg.step.ifnet`` span."""

from fgbench import counts, counts_ifnet


def read(t):
    e = t.cell["engine"]
    ks = t.kernels()
    if (t.frames_in < 2 or not ks or "learned_scale" not in e
            or not t.spans.get("tpufg.step.ifnet")):
        return None
    s = float(e["learned_scale"])
    h, w = counts_ifnet.padded(e["input_height"], e["input_width"], s)
    flops = counts_ifnet.pair_flops(h, w, s) * (t.frames_in - 1)
    busy_s = sum(d for _, _, d in ks)
    return flops / (busy_s * counts.PEAK_OPS_PER_S["bf16"]) * 100.0
