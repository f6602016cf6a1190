"""The yardstick's arithmetic: the H100's published peaks, and the bytes
and operations a piece of work needs, computed from its shapes.

The counts depend on the work (the shapes a cell runs), not on which
kernel does it, so a later kernel for the same work is held to the same
bound.  Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full
700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
F32_BYTES = 4


def bound_s(nbytes: float, ops: float = 0.0, kind: str = "f32") -> float:
    """The least time the card could take: the larger of ``nbytes``
    (each input read once, each output written once) over the memory's
    bandwidth and ``ops`` operations of type ``kind`` over its peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def lanczos_packed_bytes(in_h: int, in_w: int, out_h: int, out_w: int,
                         a: int = 3) -> int:
    """Lanczos-a resample of four f32 planes, stored as UNORM8 and packed
    into one int32 per pixel: the planes in, the two axes' tap tables
    (an int32 index and an f32 weight per tap) in, the packed frame out.
    1080p -> 4K at a = 3: 33,177,600 + 288,000 + 33,177,600 bytes."""
    taps = 2 * a
    planes = 4 * in_h * in_w * F32_BYTES
    tables = (out_h + out_w) * taps * 8
    return planes + tables + out_h * out_w * 4


def lanczos_packed_ops(in_h: int, out_h: int, out_w: int, a: int = 3) -> int:
    """f32 operations of the same resample: a ``2a``-tap multiply-add row
    at every (input row, output column), one at every output pixel, per
    channel; then a clamp and a scale per output value."""
    taps = 2 * a
    return (4 * (in_h * out_w + out_h * out_w) * (2 * taps - 1)
            + 4 * out_h * out_w * 2)


def lanczos_packed_bound_s(in_h: int, in_w: int, out_h: int, out_w: int,
                           a: int = 3) -> float:
    return bound_s(lanczos_packed_bytes(in_h, in_w, out_h, out_w, a),
                   lanczos_packed_ops(in_h, out_h, out_w, a))


def conv3x3_flops(c_in: int, c_out: int, out_h: int, out_w: int) -> int:
    """2 x the multiply-adds of a 3x3 conv at its output size."""
    return 2 * 9 * c_in * c_out * out_h * out_w


def conv_chain_flops(chans, h: int, w: int) -> int:
    """The stride-1 chain ``chans[0] -> chans[1] -> ...`` at h x w."""
    return sum(conv3x3_flops(a, b, h, w) for a, b in zip(chans, chans[1:]))


def conv_chain_bound_s(chans, h: int, w: int) -> float:
    """The chain on the bf16 tensor cores: its operations, or its first
    input and last output in f32, whichever takes longer."""
    return bound_s((chans[0] + chans[-1]) * h * w * F32_BYTES,
                   conv_chain_flops(chans, h, w), "bf16")


def _ceil2(n: int) -> int:
    return -(-n // 2)


def head_pair_flops(shapes: dict, h: int, w: int) -> int:
    """The learned head's conv FLOPs for one frame pair at frame size h x w
    (multiples of 16), with the stream cache: one frame's encoder a pair
    (enc1 and enc2, stride 2), stage 1 at 1/8 (enc3 stride 2, c_body,
    c_body2 where present, c_head) and stage 2 at 1/4 (r_in, r_body,
    r_head).  ``shapes``: {layer: (c_out, c_in)} from the checkpoint."""
    h2, w2 = _ceil2(h), _ceil2(w)
    h4, w4 = _ceil2(h2), _ceil2(w2)
    h8, w8 = _ceil2(h4), _ceil2(w4)
    at = {"enc1": (h2, w2), "enc2": (h4, w4), "enc3": (h8, w8),
          "c_body": (h8, w8), "c_body2": (h8, w8), "c_head": (h8, w8),
          "r_in": (h4, w4), "r_body": (h4, w4), "r_head": (h4, w4)}
    return sum(conv3x3_flops(ci, co, *at[name])
               for name, (co, ci) in shapes.items())


def checkpoint_shapes(path: str) -> dict:
    """{layer: (c_out, c_in)} of a head's parameter file (OIHW weights)."""
    from fgbench.reference.head import read_tree
    return {n: tuple(int(s) for s in layer["w"].shape[:2])
            for n, layer in read_tree(path).items()}
