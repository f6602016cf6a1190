"""The operations of RIFE's own network (IFNet + Contextnet + U-Net,
arXiv:2011.06294) for one frame pair, computed from the architecture's
widths, the padded frame size and RIFE's scale s (``learned_scale``): its
3x3 convs and stride-2 4x4 transposed convs, 2 x their multiply-adds, with
the stream cache (one frame's Contextnet a pair; the other frame's comes
from the cache).  985.4 GFLOP at 2176 x 3840, s = 0.5: IFNet 359.7,
Contextnet 54.7, U-Net 571.0.  Resizes, PReLUs, warps and the merge are
left out (a few GFLOP)."""

from __future__ import annotations

from fgbench.counts import conv3x3_flops

# (input channels, width) of the three IFBlocks
BLOCKS = ((6, 240), (17, 150), (17, 90))
CONVBLOCK = 8
CONTEXT = (3, 16, 32, 64, 128)


def padded(h: int, w: int, scale: float) -> tuple[int, int]:
    """The frame as the network sees it: zero-padded to a multiple of
    ``max(32, 32 / scale)`` (``inference_video.py``)."""
    m = max(32, int(32 / scale))
    return -(-h // m) * m, -(-w // m) * m


def _half(n: int) -> int:
    """A stride-2, pad-1 3x3 conv's output size."""
    return -(-n // 2)


def tconv_flops(c_in: int, c_out: int, in_h: int, in_w: int) -> int:
    """2 x the multiply-adds of a stride-2 4x4 transposed conv."""
    return 2 * 16 * c_in * c_out * in_h * in_w


def conv2_flops(c_in: int, c_out: int, h: int, w: int) -> int:
    """A ``Conv2`` at input size h x w: a stride-2 conv, then a stride-1
    one at the halved size."""
    h2, w2 = _half(h), _half(w)
    return (conv3x3_flops(c_in, c_out, h2, w2)
            + conv3x3_flops(c_out, c_out, h2, w2))


def ifblock_flops(c_in: int, c: int, h: int, w: int, scale: float) -> int:
    """One IFBlock at block scale ``scale`` on an h x w frame."""
    hs, ws = int(h / scale), int(w / scale)
    h2, w2 = _half(hs), _half(ws)
    h4, w4 = _half(h2), _half(w2)
    return (conv3x3_flops(c_in, c // 2, h2, w2)
            + conv3x3_flops(c // 2, c, h4, w4)
            + CONVBLOCK * conv3x3_flops(c, c, h4, w4)
            + tconv_flops(c, 5, h4, w4))


def ifnet_flops(h: int, w: int, scale: float) -> int:
    scales = (4.0 / scale, 2.0 / scale, 1.0 / scale)
    return sum(ifblock_flops(ci, c, h, w, s)
               for (ci, c), s in zip(BLOCKS, scales))


def context_flops(h: int, w: int) -> int:
    """One frame's Contextnet convs."""
    total = 0
    for a, b in zip(CONTEXT, CONTEXT[1:]):
        total += conv2_flops(a, b, h, w)
        h, w = _half(h), _half(w)
    return total


def unet_flops(h: int, w: int) -> int:
    total, sizes = 0, [(h, w)]
    for a, b in ((17, 32), (64, 64), (128, 128), (256, 256)):
        total += conv2_flops(a, b, *sizes[-1])
        sizes.append((_half(sizes[-1][0]), _half(sizes[-1][1])))
    # up k reads level 4 - k's size
    for k, (a, b) in enumerate(((512, 128), (256, 64), (128, 32),
                                (64, 16))):
        total += tconv_flops(a, b, *sizes[4 - k])
    return total + conv3x3_flops(16, 3, h, w)


def pair_flops(h: int, w: int, scale: float) -> int:
    """A frame pair's conv FLOPs at the padded size h x w."""
    return ifnet_flops(h, w, scale) + context_flops(h, w) + unet_flops(h, w)


# ---------------------------------------------------------------- the bytes
# of the port's hand kernels for the network (tpufg_torch/csrc/), a frame
# pair at the padded size, counted from the published widths: each input
# byte read once and each output byte written once, whatever a kernel reads
# again or pads (the port pads channel counts to multiples of 8).

BF16_BYTES, F32_BYTES = 2, 4


def _prelu_layers(h: int, w: int, scale: float) -> list:
    """(elements, destinations) of every conv output the bias-and-PReLU
    pass writes, a pair: the IFBlocks', one frame's Contextnet's, the
    U-Net's (s0..s2 go to two concatenations)."""
    out = []
    for (_, c), s in zip(BLOCKS, (4.0 / scale, 2.0 / scale, 1.0 / scale)):
        h2, w2 = _half(int(h / s)), _half(int(w / s))
        h4, w4 = _half(h2), _half(w2)
        out += [(c // 2 * h2 * w2, 1)] + [(c * h4 * w4, 1)] * (1 + CONVBLOCK)
    hk, wk = h, w
    for c in CONTEXT[1:]:
        hk, wk = _half(hk), _half(wk)
        out += [(c * hk * wk, 1)] * 2
    hk, wk = h, w
    for k, c in enumerate((32, 64, 128, 256)):
        hk, wk = _half(hk), _half(wk)
        out += [(c * hk * wk, 1), (c * hk * wk, 2 if k < 3 else 1)]
    for k, c in enumerate((128, 64, 32, 16)):
        s = 2 ** (3 - k)
        out.append((c * -(-h // s) * -(-w // s), 1))
    return out


def bias_prelu_bytes(h: int, w: int, scale: float) -> int:
    """A bf16 element read and written to each destination."""
    return sum(n * BF16_BYTES * (1 + d) for n, d in _prelu_layers(h, w, scale))


def warp_grid_bytes(h: int, w: int) -> int:
    """Both frames' three warps at full size (the flow, f32 RGB in and out;
    RGBA after the last block), and both frames' four Contextnet levels
    (the flow, bf16 features in and out)."""
    px = h * w
    frames = 2 * px * (2 * (2 + 3 + 3) + (2 + 4 + 4)) * F32_BYTES
    ctx, hk, wk = 0, h, w
    for c in CONTEXT[1:]:
        hk, wk = _half(hk), _half(wk)
        ctx += 2 * hk * wk * (2 * F32_BYTES + 2 * c * BF16_BYTES)
    return frames + ctx


def pack_bytes(h: int, w: int, scale: float) -> int:
    """f32 planes read, bf16 channels written: each IFBlock's input at its
    scale (6 planes, then 17), the new frame's RGB for the Contextnet, the
    U-Net's 17-channel input, at full size."""
    planes = []
    for (c_in, _), s in zip(BLOCKS, (4.0 / scale, 2.0 / scale, 1.0 / scale)):
        planes.append(c_in * int(h / s) * int(w / s))
    planes += [3 * h * w, 17 * h * w]
    return sum(planes) * (F32_BYTES + BF16_BYTES)


def merge_bytes(h: int, w: int) -> int:
    """Per output pixel (the cropped frame): both warped frames' RGBA and
    the mask's sigmoid in f32 and the residual's three bf16 read, the
    RGBA written."""
    return h * w * ((2 * 4 + 1 + 4) * F32_BYTES + 3 * BF16_BYTES)


def accum_bytes(h: int, w: int, scale: float) -> int:
    """Each block's 5 bf16 channels at 1 / (2S) read; the f32 flow and mask
    (5 channels) written, and read back after the first block."""
    total = 0
    for k, s in enumerate((4.0 / scale, 2.0 / scale, 1.0 / scale)):
        small = int(h / (2 * s)) * int(w / (2 * s))
        total += 5 * small * BF16_BYTES + 5 * h * w * F32_BYTES * (
            1 if k == 0 else 2)
    return total


def kernel_bytes(engine: dict) -> dict:
    """{kernel: (name parts in the device trace, bytes a pair)} of the
    cell's ``engine`` settings."""
    s = float(engine["learned_scale"])
    ih, iw = engine["input_height"], engine["input_width"]
    h, w = padded(ih, iw, s)
    return {
        "bias_prelu": (("bias_prelu_",), bias_prelu_bytes(h, w, s)),
        "warp_grid": (("warp_planar_f32", "warp_nhwc_bf16"),
                      warp_grid_bytes(h, w)),
        "pack_nhwc": (("pack_nhwc_kernel",), pack_bytes(h, w, s)),
        "ifnet_merge": (("ifnet_merge_kernel",), merge_bytes(ih, iw)),
        "ifnet_accum": (("ifnet_accum_kernel",), accum_bytes(h, w, s)),
    }


def roofline_pct(t, kernel: str):
    """``kernel``'s bytes a pair over HBM's 3.35 TB/s, times the traced
    window's pairs, over the device time of its launches there, %; None
    where the window ran no ``tpufg.step.ifnet`` span or no such launch."""
    from fgbench import counts
    e = t.cell["engine"]
    if (t.frames_in < 2 or "learned_scale" not in e
            or not t.spans.get("tpufg.step.ifnet")):
        return None
    parts, nbytes = kernel_bytes(e)[kernel]
    busy = sum(d for name, _, d in t.device.get("kernel", [])
               if any(p in name for p in parts))
    if busy <= 0:
        return None
    return nbytes * (t.frames_in - 1) / counts.HBM_BYTES_PER_S / busy * 100.0
