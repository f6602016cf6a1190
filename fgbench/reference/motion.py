"""Motion search and motion-compensated warps: the box pyramid, the
lattice block search, and the block warps (whole-pixel and fractional).

Frozen from the port's plain paths:
- box: ``0.5*(0.5*a + 0.5*c) + 0.5*(0.5*b + 0.5*d)`` in f32;
- lattice search: at each 16-px cell's 8x8 centre block, every candidate
  of radius r; per pixel the channels' squared differences added in turn,
  then sqrt; the block's rows added top to bottom, then its columns; the
  first minimum in dy-major order wins;
- pyramid (config 4's latency mode): 3 levels, radius 4 at the coarsest,
  then per finer level a 2x repeat of the lattice, values doubled, a
  whole-pixel warp of prev by the estimate and a radius-2 residual search;
  the finest level is upsampled without a search;
- block warp: each block of g pixels moves by its clipped MV times the
  blend weight.  Whole-pixel moves gather one tap (the engine's blend moves
  centred integer codes ``round(255 x) - 128`` in the compute type); a
  fractional move lerps two taps horizontally (products and sum in f32,
  rounded once) and the two rows vertically in the compute type; samples
  whose source leaves the frame are blanked in the blend.
"""

from __future__ import annotations

import numpy as np
import torch

from fgbench.reference.frames import INV255

F32 = torch.float32


def box2(img: torch.Tensor) -> torch.Tensor:
    x = img.to(F32)
    v0 = 0.5 * x[:, 0::2, 0::2] + 0.5 * x[:, 1::2, 0::2]
    v1 = 0.5 * x[:, 0::2, 1::2] + 0.5 * x[:, 1::2, 1::2]
    return 0.5 * v0 + 0.5 * v1


def lattice_search(prev: torch.Tensor, curr: torch.Tensor, grid: int = 16,
                   block: int = 8, radius: int = 4) -> torch.Tensor:
    """Planar [C, H, W] -> f32 [2, H/grid, W/grid] backward-flow MVs
    (dx, dy) at the cells' centre blocks."""
    n_ch, h, w = prev.shape
    g, b, r = grid, block, radius
    off = (g - b) // 2
    if off - r < 0 or off + b + r > g:
        raise ValueError(f"radius {r} leaves the {g}-px cell")
    hb, wb = h // g, w // g
    n = 2 * r + 1
    cells = prev.to(F32).reshape(n_ch, hb, g, wb, g)
    win = cells[:, :, off - r:off + b + r, :, off - r:off + b + r]
    cand = win.unfold(2, b, 1).unfold(4, b, 1)
    cand = cand.permute(2, 4, 0, 1, 5, 3, 6).reshape(n * n, n_ch, hb, b, wb,
                                                     b)
    blk = curr.to(F32).reshape(n_ch, hb, g, wb, g)[:, :, off:off + b, :,
                                                    off:off + b]
    d = blk[0] - cand[:, 0]
    acc = d * d
    for ci in range(1, n_ch):
        d = blk[ci] - cand[:, ci]
        acc = acc + d * d
    dist = torch.sqrt(acc)
    rows = dist[:, :, 0]
    for ky in range(1, b):
        rows = rows + dist[:, :, ky]
    cost = rows[..., 0]
    for kx in range(1, b):
        cost = cost + rows[..., kx]
    best = torch.argmin(cost, dim=0)
    dys, dxs = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                           indexing="ij")
    table = torch.from_numpy(np.stack([dxs.reshape(-1), dys.reshape(-1)])
                             .astype(np.float32)).to(prev.device)
    return table[:, best]


def _block_offsets(md: torch.Tensor, scale: float, g: int) -> torch.Tensor:
    o = md * scale
    return o.repeat_interleave(g, dim=0).repeat_interleave(g, dim=1)


def _gather(v: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    c, h, w = v.shape
    flat = (torch.clamp(rows, 0, h - 1) * w
            + torch.clamp(cols, 0, w - 1)).reshape(-1)
    return v.reshape(c, h * w)[:, flat].reshape(c, h, w)


def _frac_warp(v: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
               q) -> torch.Tensor:
    _, h, w = v.shape
    ys = torch.arange(h, device=v.device)[:, None]
    xs = torch.arange(w, device=v.device)[None, :]
    fy, fx = torch.floor(oy), torch.floor(ox)
    rows = ys + fy.to(torch.int64)
    cols = xs + fx.to(torch.int64)
    wy, wx = q(oy - fy), q(ox - fx)

    def row_lerp(at: torch.Tensor) -> torch.Tensor:
        a, b = _gather(v, at, cols), _gather(v, at, cols + 1)
        return q(a * q(1.0 - wx) + b * wx)

    return q(q(row_lerp(rows) * q(1.0 - wy)) + q(row_lerp(rows + 1) * wy))


def _move(x: torch.Tensor, md: torch.Tensor, scale: float, g: int, q,
          integer: bool, int_domain: bool) -> torch.Tensor:
    """One side of a warp: into the domain values move in (centred, or
    centred integer codes), moved by the block MVs times ``scale``, back.
    ``q`` rounds to the compute type (None: f32)."""
    q = q or (lambda t: t)
    x = x.to(F32)
    v = q(torch.round(x * 255.0) - 128.0 if int_domain else x - 0.5)
    ox = _block_offsets(md[0], scale, g)
    oy = _block_offsets(md[1], scale, g)
    if integer:
        _, h, w = v.shape
        o = _gather(v, torch.arange(h, device=v.device)[:, None]
                    + torch.floor(oy).to(torch.int64),
                    torch.arange(w, device=v.device)[None, :]
                    + torch.floor(ox).to(torch.int64))
    else:
        o = _frac_warp(v, ox, oy, q)
    if int_domain:
        return (o + 128.0) * INV255
    return o + 0.5


def warp_single(x: torch.Tensor, mv: torch.Tensor, block: int, radius: int,
                q=None, integer: bool = False) -> torch.Tensor:
    """x [C, H, W] moved by its block MVs [2, H/g, W/g] clipped to
    +-radius."""
    md = torch.clamp(mv.to(F32), -radius, radius)
    return _move(x, md, 1.0, block, q, integer, False)


def _inside(md: torch.Tensor, scale: float, g: int, h: int,
            w: int) -> torch.Tensor:
    fx = _block_offsets(md[0], scale, g)
    fy = _block_offsets(md[1], scale, g)
    px = torch.arange(w, device=fx.device, dtype=F32)[None, :] + fx
    py = torch.arange(h, device=fx.device, dtype=F32)[:, None] + fy
    ok = (px >= -0.5) & (px <= w - 0.5) & (py >= -0.5) & (py <= h - 0.5)
    return ok.to(F32)[None]


def warp_blend(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
               factor: float, block: int, radius: int, q,
               crop: tuple[int, int]) -> torch.Tensor:
    """The engine's whole-pixel blend at time ``factor``: prev moved by
    ``-factor * mv``, curr by ``(1 - factor) * mv``, as integer codes in
    the compute type, each masked where it left the frame, blended in f32,
    cropped to ``crop``."""
    _, h, w = prev.shape
    t = float(np.float32(factor))
    one_t = float(np.float32(1.0) - np.float32(factor))
    md = torch.clamp(mv.to(F32), -radius, radius)
    wp = _move(prev, md, -t, block, q, True, True)
    wc = _move(curr, md, one_t, block, q, True, True)
    mp = _inside(md, -t, block, h, w)
    mc = _inside(md, one_t, block, h, w)
    out = wp * mp * one_t + wc * mc * t
    return out[:, :crop[0], :crop[1]].contiguous()


def pyramid_mv(prev: torch.Tensor, curr: torch.Tensor, levels: int = 3,
               base_radius: int = 4, refine_radius: int = 2, block: int = 8,
               grid: int = 16) -> torch.Tensor:
    """Config 4's pyramid search, the finest refine skipped: planar
    [C, H, W] (H, W multiples of grid * 2**(levels-1)) -> f32
    [2, H/grid, W/grid]."""
    pyr = [(prev.to(F32), curr.to(F32))]
    for _ in range(levels - 1):
        p, c = pyr[-1]
        pyr.append((box2(p), box2(c)))
    mv = lattice_search(*pyr[-1], grid, block, base_radius)
    for lvl in range(levels - 2, -1, -1):
        mv = mv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0
        if lvl < 1:
            continue
        reach = base_radius * 2 ** (levels - 1 - lvl) + sum(
            refine_radius * 2 ** k for k in range(levels - 1 - lvl))
        p_l, c_l = pyr[lvl]
        warped = warp_single(p_l, mv, grid, max(reach, 1), integer=True)
        mv = mv + lattice_search(warped, c_l, grid, block, refine_radius)
    return mv
