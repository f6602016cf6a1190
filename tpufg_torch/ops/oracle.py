"""The executable specification in plain PyTorch: the f32 oracle ops.

Counterpart of ``tpufg/ops/oracle.py``, the 1:1 transcriptions of the
reference's three GLSL compute shaders (scale.comp, motion.comp,
interpolate.comp) that the exact precision path runs end to end.  Every
function takes tensors on any device and computes in float32; the
conventions the shaders leave open (pixel-unit MVs, clamp-to-edge fetches,
strict ``<`` first-found argmin, UNORM8 round-to-nearest-even, the flow
direction of reference bug #12) are tpufg's, documented there.

**Roundings.**  tpufg's exact step runs these ops under ``jax.jit``, and
XLA's CPU compiler changes how they round.  The port follows the compiled
program, not the source text:

- a division by a constant is a multiply by its f32 reciprocal (``/ 255``,
  ``/ out_size``, ``/ a``, ``/ w`` and ``/ h``);
- a product of constants is folded into one f32 constant: the tap
  position ``(i + 0.5) / out * in`` is ``(i + 0.5) * fl(fl(1/out) * in)``,
  the crossfade's sample position ``(p + 0.5) / w * w`` likewise, and the
  MV's uv step ``m / w * s`` is ``m * fl(fl(1/w) * s)``;
- a multiply whose only use is an add is fused into it (an FMA): the tap
  and sample positions ``p * s - 0.5``, the Lanczos accumulation
  ``color + texel * w`` (from the second tap on; the first two products
  are summed with the first one fused), the bilinear lerps and the blend
  (``a * (1 - f) + b * f`` with the first product fused), and the MV's
  uv step ``u + m * k`` unless the prev and curr steps share one product
  (``t = 0.5``: then ``fl(m * k)`` is added);
- everything else rounds once an operation.

An FMA is written as :func:`_fma`, the f64 product of the two f32
operands (exact) plus the f64 addend, rounded to f32: the form of
``kernels/resize.py::resize_linear``, and of the CUDA kernels of
``kernels/oracle.py`` (``__dmul_rn`` + ``__dadd_rn`` +
``__double2float_rn``).  The motion search keeps one rounding an
operation, the rule of ``csrc/motion_tiled.cu`` and its plain version:
its contract is the MV field, which a last-bit change of a cost moves
only at a tie.

The Lanczos weights take ``torch.sin`` on the tensor's device; XLA's CPU
sine agrees with torch's on the CPU at 2x and identity ratios and
differs in the last bit on some taps at 4:3 ratios.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
F64 = torch.float64
_f32 = np.float32

# the reference shader's pi literal (scale.comp:18), rounded to f32
_PI = float(_f32(3.14159265359))
# UNORM8 read: x / 255 as XLA compiles it, x * fl(1/255)
_R255 = float(_f32(1) / _f32(255))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32: the f64 product of f32 operands
    is exact, the f64 sum rounds, then f32.  ``b`` and ``c`` may be
    tensors or Python floats that hold f32 values."""
    b = b.to(F64) if isinstance(b, torch.Tensor) else b
    c = c.to(F64) if isinstance(c, torch.Tensor) else c
    return (a.to(F64) * b + c).to(F32)


def _lerp(a: torch.Tensor, b: torch.Tensor, f) -> torch.Tensor:
    """GLSL ``mix(a, b, f) = a * (1 - f) + b * f`` as XLA compiles it:
    ``a``'s product fused into the sum of ``b``'s."""
    return _fma(a, 1.0 - f, b * f)


def lanczos_weight(x: torch.Tensor, a: int = 3) -> torch.Tensor:
    """Lanczos window weight (scale.comp:16-20): 1 at 0, else
    ``a * sin(pi x) * sin(pi x / a) / (pi x)^2`` with ``/ a`` as a multiply
    by ``fl(1/a)``.  No cut-off at ``|x| >= a``, as the shader."""
    x = x.to(F32)
    zero = x == 0
    safe = torch.where(zero, torch.ones_like(x), x * _PI)
    w = (torch.sin(safe) * float(a)) * torch.sin(
        safe * float(_f32(1) / _f32(a))) / (safe * safe)
    return torch.where(zero, torch.ones_like(x), w)


def _axis_taps(in_size: int, out_size: int, a: int,
               device: torch.device | str = "cpu"):
    """Tap indices and filter arguments of one axis (scale.comp:24-26):
    (texel indices int64 [out, 2a], possibly out of range; deltas f32
    [out, 2a]; valid bool [out, 2a], the taps inside the image)."""
    idx = torch.arange(out_size, dtype=F32, device=device)
    # (i + 0.5) / out * in - 0.5: one constant, the multiply fused
    step = float(_f32(_f32(1) / _f32(out_size)) * _f32(in_size))
    pos = _fma(idx + 0.5, step, -0.5)
    fl = torch.floor(pos)
    frac = pos - fl
    k = torch.arange(2 * a, dtype=F32, device=device)
    coords = (fl - float(a - 1))[:, None] + k[None, :]
    deltas = (k[None, :] - frac[:, None]) - float(a - 1)
    valid = (coords >= 0) & (coords <= in_size - 1)
    return coords.to(torch.int64), deltas, valid


@functools.lru_cache(maxsize=32)
def axis_tables(in_size: int, out_size: int, a: int,
                device: torch.device) -> tuple:
    """One axis's tap tables, made once per shape and device: (clamped
    texel index int64 [out, 2a], Lanczos weight f32 [out, 2a], valid bool
    [out, 2a]).  :func:`lanczos_scale` and the CUDA kernel of
    ``kernels/oracle.py`` read the same tables."""
    coords, deltas, valid = _axis_taps(in_size, out_size, a, device)
    return (coords.clamp(0, in_size - 1), lanczos_weight(deltas, a), valid)


def lanczos_scale(img: torch.Tensor, out_h: int, out_w: int,
                  a: int = 3) -> torch.Tensor:
    """Lanczos-a resample (scale.comp:51-61): f32 [H, W, C] -> f32
    [out_h, out_w, C].

    The 2a x 2a window at ``floor(pos) - (a - 1)``; taps outside the image
    drop out of both sums; ``w = wx * wy``; y outer, x inner; one division
    by the weight sum at the end."""
    img = img.to(F32)
    in_h, in_w, _ = img.shape
    iy, wy, vy = axis_tables(in_h, out_h, a, img.device)
    ix, wx, vx = axis_tables(in_w, out_w, a, img.device)
    color = total = first = None
    for ky in range(2 * a):              # y outer (scale.comp:31)
        rows = img[iy[:, ky]]
        for kx in range(2 * a):          # x inner (scale.comp:32)
            w = wx[None, :, kx] * wy[:, None, ky]
            w = torch.where(vx[None, :, kx] & vy[:, None, ky], w,
                            torch.zeros((), dtype=F32, device=img.device))
            texel = rows[:, ix[:, kx]]
            wc = w[:, :, None]
            total = w if total is None else total + w
            if first is None:
                first = (texel, wc)
            elif color is None:
                color = _fma(first[0], first[1], texel * wc)
            else:
                color = _fma(texel, wc, color)
    return color / total[:, :, None]     # scale.comp:48


def _euclidean_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GLSL ``distance(a, b)`` over the last axis, the channel sum left to
    right, one rounding an operation."""
    d = a - b
    acc = d[..., 0] * d[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + d[..., c] * d[..., c]
    return torch.sqrt(acc)


def motion_search(prev: torch.Tensor, curr: torch.Tensor,
                  block_size: int = 8,
                  search_radius: int = 16) -> torch.Tensor:
    """Exhaustive per-pixel block matching (motion.comp:16-57): f32
    [H, W, C] frames -> f32 [H, W, 2] (dx, dy) in pixels (backward flow:
    curr[q] ~= prev[q + mv]).

    The block at ``p - b/2``; out-of-image block pixels weigh 0; the prev
    fetch clamps to the edge; the block sum runs y outer, x inner; the
    argmin is the first strict minimum of the dy-outer / dx-inner scan
    from (0, 0) at cost 1e10."""
    prev = prev.to(F32)
    curr = curr.to(F32)
    h, w, _ = curr.shape
    b, r = int(block_size), int(search_radius)
    anchor = b // 2
    dev = curr.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    best = torch.full((h, w), 1e10, dtype=F32, device=dev)
    best_dx = torch.zeros((h, w), dtype=F32, device=dev)
    best_dy = torch.zeros((h, w), dtype=F32, device=dev)
    for dy in range(-r, r + 1):          # dy outer (motion.comp:27)
        prev_rows = prev[(rows + dy).clamp(0, h - 1)]
        for dx in range(-r, r + 1):      # dx inner (motion.comp:28)
            shifted = prev_rows[:, (cols + dx).clamp(0, w - 1)]
            dist = F.pad(_euclidean_distance(curr, shifted),
                         (anchor, b - 1 - anchor, anchor, b - 1 - anchor))
            cost = dist[0:h, 0:w]
            for by in range(b):
                for bx in range(b):
                    if by or bx:
                        cost = cost + dist[by:by + h, bx:bx + w]
            upd = cost < best            # strict <: first found wins
            best = torch.where(upd, cost, best)
            best_dx = torch.where(upd, float(dx), best_dx)
            best_dy = torch.where(upd, float(dy), best_dy)
    return torch.stack([best_dx, best_dy], dim=-1)


def _bilinear_at(img: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of f32 [H, W, C] at texel-space positions ``x``,
    ``y`` (the texel centre at integer + 0.5 already subtracted), indices
    clamped to the edge: ``mix(mix(c00, c10, fx), mix(c01, c11, fx),
    fy)``."""
    h, w, _ = img.shape
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    top = _lerp(img[ya, xa], img[ya, xb], fx)
    bot = _lerp(img[yb, xa], img[yb, xb], fx)
    return _lerp(top, bot, fy)


def bilinear_sample(img: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """GLSL ``texture()`` with LINEAR filtering and CLAMP_TO_EDGE: f32
    [H, W, C] at normalised coordinates ``u``, ``v`` -> f32 [..., C].  The
    texel position ``u * W - 0.5`` is one FMA."""
    h, w, _ = img.shape
    return _bilinear_at(img.to(F32), _fma(u.to(F32), float(w), -0.5),
                        _fma(v.to(F32), float(h), -0.5))


class WarpTables(NamedTuple):
    """The constants and per-axis tables of :func:`warp_blend`, shared
    with the CUDA kernel."""
    u: torch.Tensor       # [w] pixel centres (p + 0.5) * fl(1/w)
    v: torch.Tensor       # [h]
    x: torch.Tensor       # [w] their texel positions with no MV
    y: torch.Tensor       # [h]
    t: float              # the blend factor in f32
    omt: float            # 1 - t in f32
    kx: tuple             # the uv step of one pixel of MV in x: (prev, curr)
    ky: tuple             # in y
    fuse_x: bool          # whether u + m * kx is one FMA
    fuse_y: bool


@functools.lru_cache(maxsize=32)
def warp_tables(h: int, w: int, factor: float,
                device: torch.device | str = "cpu") -> WarpTables:
    """:class:`WarpTables` of an [h, w] frame at blend factor ``factor``,
    made once per shape, factor and device: ``x``, ``y`` one FMA with the
    folded constant ``fl(fl(1/size) * size)``; per sample (prev at ``-t``,
    curr at ``1 - t``) ``k = fl(fl(1/size) * scale)``; ``u + m * k`` is not
    fused where the prev and curr steps are one product up to sign."""
    t = _f32(factor)
    omt = _f32(1) - t
    rw, rh = _f32(1) / _f32(w), _f32(1) / _f32(h)
    px = torch.arange(w, dtype=F32, device=device) + 0.5
    py = torch.arange(h, dtype=F32, device=device) + 0.5
    kx = (float(rw * -t), float(rw * omt))
    ky = (float(rh * -t), float(rh * omt))
    return WarpTables(
        u=px * float(rw), v=py * float(rh),
        x=_fma(px, float(rw * _f32(w)), -0.5),
        y=_fma(py, float(rh * _f32(h)), -0.5),
        t=float(t), omt=float(omt), kx=kx, ky=ky,
        fuse_x=kx[0] != -kx[1], fuse_y=ky[0] != -ky[1])


def warp_blend(prev: torch.Tensor, curr: torch.Tensor,
               motion: Optional[torch.Tensor],
               factor: float) -> torch.Tensor:
    """Motion-compensated blend (interpolate.comp:24-40): f32 [H, W, C]
    prev and curr, ``motion`` f32 [Hm, Wm, 2] in pixels (a texel fetch at
    the frame's size, a bilinear resample of a coarser grid) or None (a
    crossfade), blend factor ``factor`` -> f32 [H, W, C].

    prev is sampled at ``uv - t * muv``, curr at ``uv + (1 - t) * muv``
    (``muv`` = the MV over the frame size); a sample whose uv leaves
    [0, 1] on either axis reads 0; the result is ``mix(prev, curr, t)``."""
    prev = prev.to(F32)
    curr = curr.to(F32)
    h, w, _ = curr.shape
    tb = warp_tables(h, w, factor, curr.device)
    if motion is None:
        # no MV: every sample is at its pixel centre, never outside
        x = tb.x[None, :].expand(h, w)
        y = tb.y[:, None].expand(h, w)
        cols = [_bilinear_at(f, x, y) for f in (prev, curr)]
    else:
        motion = motion.to(F32)
        if motion.shape[:2] == (h, w):
            mdx, mdy = motion[..., 0], motion[..., 1]
        else:
            # a coarser grid: bilinear at the pixel centres (u and v have
            # other uses, so no constant is folded into them here)
            hm, wm, _ = motion.shape
            mx = _fma(tb.u, float(wm), -0.5)
            my = _fma(tb.v, float(hm), -0.5)
            m = _bilinear_at(motion, mx[None, :].expand(h, w),
                             my[:, None].expand(h, w))
            mdx, mdy = m[..., 0], m[..., 1]
        u = tb.u[None, :]
        v = tb.v[:, None]
        cols = []
        for s, frame in enumerate((prev, curr)):
            kx, ky = tb.kx[s], tb.ky[s]
            su = _fma(mdx, kx, u) if tb.fuse_x else u + mdx * kx
            sv = _fma(mdy, ky, v) if tb.fuse_y else v + mdy * ky
            oob = (su < 0) | (su > 1) | (sv < 0) | (sv > 1)
            col = _bilinear_at(frame, _fma(su, float(w), -0.5),
                               _fma(sv, float(h), -0.5))
            cols.append(torch.where(oob[..., None], 0.0, col))
    return _fma(cols[0], tb.omt, cols[1] * tb.t)


def quantize_unorm8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> uint8 as Vulkan's UNORM8 store: clamp to [0, 1], scale by
    255, round to nearest even."""
    return torch.round(torch.clamp(x.to(F32), 0.0, 1.0) * 255.0).to(
        torch.uint8)


def dequantize_unorm8(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> f32 in [0, 1] (UNORM read): ``x * fl(1/255)``, XLA's
    form of ``x / 255``."""
    return x.to(F32) * _R255
