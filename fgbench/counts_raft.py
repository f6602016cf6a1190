"""The operations and bytes of RAFT's optical flow (arXiv:2003.12039,
github.com/princeton-vl/RAFT) for one frame pair, computed from the
architecture's widths and the frame size padded to a multiple of 8: its
convs (2 x their multiply-adds, at the published widths), with the stream
cache (curr's two encoders a pair; prev's come from the cache), the
all-pairs correlation and 12 updates.  3,210.6 GFLOP at 1080 x 1920:
correlation 537.5 (32,400^2 x 256 multiply-adds), encoders 563.6, updates
2,080.8 (173.4 each), the last mask 28.7.  Norms, activations, pooling,
the lookup, the upsampling and the warps are left out."""

from __future__ import annotations

from fgbench.counts import F32_BYTES

ITERS = 12
LEVELS = 4
RADIUS = 4
TAPS = LEVELS * (2 * RADIUS + 1) ** 2     # 324
BF16_BYTES = 2
# (name, width, stride) of the encoders' three stages
STAGES = ((64, 1), (96, 2), (128, 2))


def padded(h: int, w: int) -> tuple[int, int]:
    """The frame as the network sees it: ``InputPadder``'s multiple of 8."""
    return -(-h // 8) * 8, -(-w // 8) * 8


def conv_flops(c_in: int, c_out: int, kh: int, kw: int, out_h: int,
               out_w: int) -> int:
    return 2 * c_in * c_out * kh * kw * out_h * out_w


def _half(n: int) -> int:
    return -(-n // 2)


def encoder_flops(h: int, w: int) -> int:
    """One BasicEncoder on an h x w frame (``fnet`` and ``cnet`` alike)."""
    h, w = _half(h), _half(w)
    total = conv_flops(3, 64, 7, 7, h, w)
    cin = 64
    for dim, stride in STAGES:
        if stride != 1:
            h, w = _half(h), _half(w)
            total += conv_flops(cin, dim, 1, 1, h, w)
        total += conv_flops(cin, dim, 3, 3, h, w)
        total += 3 * conv_flops(dim, dim, 3, 3, h, w)
        cin = dim
    return total + conv_flops(128, 256, 1, 1, h, w)


def corr_flops(h: int, w: int) -> int:
    """The all-pairs correlation at 1/8 of an h x w frame."""
    n = (h // 8) * (w // 8)
    return 2 * n * n * 256


def update_flops(h: int, w: int) -> int:
    """One update at 1/8 size."""
    h8, w8 = h // 8, w // 8
    return sum(conv_flops(ci, co, kh, kw, h8, w8) for ci, co, kh, kw in (
        (TAPS, 256, 1, 1), (256, 192, 3, 3), (2, 128, 7, 7),
        (128, 64, 3, 3), (256, 126, 3, 3)) + ((384, 128, 1, 5),) * 6 + (
        (128, 256, 3, 3), (256, 2, 3, 3)))


def mask_flops(h: int, w: int) -> int:
    h8, w8 = h // 8, w // 8
    return (conv_flops(128, 256, 3, 3, h8, w8)
            + conv_flops(256, 576, 1, 1, h8, w8))


def pair_flops(h: int, w: int) -> int:
    """A frame pair's FLOPs at the padded size h x w."""
    return (corr_flops(h, w) + 2 * encoder_flops(h, w)
            + ITERS * update_flops(h, w) + mask_flops(h, w))


# ---------------------------------------------------------------- the bytes
# of the port's two hand kernels for the network (tpufg_torch/csrc/), a
# frame pair at the padded size, from the published widths: each input byte
# read once and each output byte written once.

def lookup_bytes(h: int, w: int) -> int:
    """12 lookups: per 1/8 pixel and level the 10 x 10 f32 patch its 9 x 9
    bilinear window reads, and its 324 bf16 channels written (874 MB at
    1080p)."""
    n = (h // 8) * (w // 8)
    return ITERS * (n * TAPS * BF16_BYTES + n * LEVELS * 100 * F32_BYTES)


def upsample_bytes(h: int, w: int) -> int:
    """The bf16 mask (576 channels) and the f32 flow at 1/8 read, the f32
    flow at full size written (54.2 MB at 1080p)."""
    n = (h // 8) * (w // 8)
    return (576 * BF16_BYTES + 2 * F32_BYTES) * n + 2 * h * w * F32_BYTES


def kernel_bytes(engine: dict) -> dict:
    """{kernel: (name parts in the device trace, bytes a pair)} of the
    cell's ``engine`` settings."""
    h, w = padded(engine["input_height"], engine["input_width"])
    return {
        "corr_lookup": (("corr_lookup_kernel",), lookup_bytes(h, w)),
        "convex_upsample": (("convex_upsample_kernel",),
                            upsample_bytes(h, w)),
    }


def pairs(t):
    """The traced window's frame pairs where it ran RAFT's step (a
    ``tpufg.step.raft`` span), else None."""
    if t.frames_in < 2 or not t.spans.get("tpufg.step.raft"):
        return None
    return t.frames_in - 1


def roofline_pct(t, kernel: str):
    """``kernel``'s bytes a pair over HBM's 3.35 TB/s, times the traced
    window's pairs, over the device time of its launches there, %; None
    where the window ran no RAFT step or no such launch."""
    from fgbench import counts
    n = pairs(t)
    if n is None:
        return None
    parts, nbytes = kernel_bytes(t.cell["engine"])[kernel]
    busy = sum(d for name, _, d in t.device.get("kernel", [])
               if any(p in name for p in parts))
    if busy <= 0:
        return None
    return nbytes * n / counts.HBM_BYTES_PER_S / busy * 100.0
