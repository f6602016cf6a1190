"""The learned head's share of the card's bf16 peak while the step runs,
%: its conv FLOPs a frame pair (``counts.head_pair_flops``, from the
checkpoint's layer shapes at the cell's size; 85.5 GFLOP at 4K) times the
pairs the traced window ran, over the device time of all the window's
kernels (the whole step: unpack, head, warps, pack) times 989 TFLOP/s.
Copies and the time the device waits for the source are left out, so a
live cell reads the step's speed and not its offered rate."""

from fgbench import counts


def read(t):
    e, ck = t.cell["engine"], t.cell.get("checkpoint")
    ks = t.kernels()
    if not ck or t.frames_in < 2 or not ks:
        return None
    import os
    shapes = counts.checkpoint_shapes(os.path.join(t.cell["root"], ck))
    h, w = -(-e["input_height"] // 16) * 16, -(-e["input_width"] // 16) * 16
    flops = counts.head_pair_flops(shapes, h, w) * (t.frames_in - 1)
    busy_s = sum(d for _, _, d in ks)
    return flops / (busy_s * counts.PEAK_OPS_PER_S["bf16"]) * 100.0
