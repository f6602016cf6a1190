"""Hierarchical (coarse-to-fine) block-matching motion search.

Counterpart of ``tpufg/models/pyramid.py::pyramid_motion_search``: a 2x
box pyramid (CUDA kernel csrc/box2.cu), an exhaustive small-radius search
at the coarsest level, then per finer level a 2x MV upsample, a warp of
prev by the estimate and a residual search.  Each search is the lattice
search while the radius keeps the candidate windows inside the grid cell,
and otherwise the per-pixel tiled search (CUDA kernel csrc/motion_tiled.cu)
subsampled at the block centres, as in tpufg (which passes no ``bias`` to
the tiled search).  Output: f32 [2, H/grid, W/grid] backward-flow MVs in
full-resolution pixels.

With a temporal ``seed`` (``--temporal-mv``, the previous pair's field)
the coarsest level first warps prev by the seed's coarse-cell means and
searches only the residual, so the reach grows by up to
``TEMPORAL_CLAMP`` px; the seeded estimates are fractional, so every warp
of a seeded search lerps (the engine's warp kernel in its fractional
single mode).

The quality preset's MV post-processing is here too: ``subpel_refine``
(the +-1 px re-search with a parabolic sub-pixel fit) and
``median_filter_mv`` (the 3x3 median on the lattice).  Both are XLA ops in
tpufg, so plain torch is their port; the refine's probe warp is the
engine's warp kernel.  The kernels take their plain versions as
``kernels.common.plain_versions`` says.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.motion import tiled_block_mv
from tpufg_torch.kernels.motion_xla import motion_search_lattice
from tpufg_torch.kernels.resize import box_downsample2
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul

# max |temporal seed| in full-resolution pixels (tpufg's constant): it
# bounds the seeded coarse warp's reach (48 / 4 = 12 coarse px at 3
# levels) and widens the engine warp's to TEMPORAL_CLAMP + 24 when seeded
TEMPORAL_CLAMP = 48
# the engine warp's reach limit (kernels/warp_matmul.py::_check_reach)
_WARP_REACH = 54


def _lattice_ok(radius: int, block: int, grid: int) -> bool:
    """The lattice search applies when candidate windows stay in-cell."""
    off = (grid - block) // 2
    return off - radius >= 0 and off + block + radius <= grid


def median_filter_mv(mv: torch.Tensor) -> torch.Tensor:
    """3x3 per-component median on the MV lattice [2, Hb, Wb], the lattice
    edge-replicated.  The median of nine values is one of them: bitwise."""
    _, hb, wb = mv.shape
    p = F.pad(mv[None], (1, 1, 1, 1), mode="replicate")[0]
    taps = torch.stack([p[:, i:i + hb, j:j + wb]
                        for i in range(3) for j in range(3)])
    return torch.sort(taps, dim=0, stable=True).values[4].to(mv.dtype)


# the nine offsets (dy, dx) of the refine, dy-major as tpufg stacks them
_SUBPEL_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@functools.lru_cache(maxsize=8)
def _subpel_penalty(bias: float, device: torch.device) -> torch.Tensor:
    """[9, 1, 1] f32 ``bias * (|dx| + |dy|)`` per offset, as tpufg's
    ``F32(bias * (abs(dx) + abs(dy)))``; made once per device (a copy from
    the host in every step would wait for the device)."""
    pen = np.array([bias * (abs(dx) + abs(dy)) for dy, dx in _SUBPEL_OFFSETS],
                   dtype=np.float32)
    return torch.from_numpy(pen.reshape(9, 1, 1)).to(device)


def _parabola(cm: torch.Tensor, c0: torch.Tensor,
              cp: torch.Tensor) -> torch.Tensor:
    """The vertex of the parabola through three costs at -1, 0, +1, within
    +-0.5 (0 where the triple is not convex)."""
    denom = cm - 2.0 * c0 + cp
    frac = torch.where(denom > 1e-6, 0.5 * (cm - cp) / denom,
                       torch.zeros_like(denom))
    return torch.clamp(frac, -0.5, 0.5)


def subpel_refine(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
                  grid: int = 16, search_radius: int = 16, bias: float = 0.0,
                  iters: int = 2, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """Full-resolution +-1 px re-search and parabolic sub-pixel fit of the
    lattice MVs ``mv`` [2, H/grid, W/grid] (backward flow) of planar
    [C, H, W] frames; returns the refined f32 field.

    Each of ``iters`` rounds warps ``prev`` by the estimate (the engine's
    fractional single warp at block ``grid``, in ``dtype``, its reach
    ``min(search_radius, 54)``), scores the 3x3 integer offsets around it
    (per pixel the Euclidean distance over the channels, summed over the
    site's grid cell, plus ``bias * (|dx| + |dy|)``), takes the first
    minimum and fits a parabola along each axis through the minimum and its
    neighbours (0 at the 3x3 rim).  The sums run in torch's order, not
    XLA's: the costs can differ from tpufg's in the last bits.
    """
    _, h, w = prev.shape
    g = int(grid)
    n_by, n_bx = h // g, w // g
    p32, c32 = prev.to(torch.float32), curr.to(torch.float32)
    mv = mv.to(torch.float32)
    r_probe = min(int(search_radius), 54)
    pen = _subpel_penalty(float(bias), prev.device) if bias else None
    for _ in range(max(1, int(iters))):
        warped = warp_blend_matmul(p32, p32, mv, block=g,
                                   search_radius=r_probe, single=True,
                                   dtype=dtype)
        wp = F.pad(warped[None], (1, 1, 1, 1), mode="replicate")[0]
        d = torch.stack([wp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy, dx in _SUBPEL_OFFSETS]) - c32  # [9,C,H,W]
        e = torch.sqrt(torch.clamp_min((d * d).sum(dim=1), 0.0))
        flat = e.view(9, n_by, g, n_bx, g).sum(dim=(2, 4))   # [9, Hb, Wb]
        if pen is not None:
            flat = flat + pen
        best = torch.argmin(flat, dim=0, keepdim=True)       # first minimum
        by, bx = best // 3 - 1, best % 3 - 1
        # tpufg fits the parabola along y only where the minimum lies in the
        # middle row, through that column's three costs, and along x only
        # where it lies in the middle column: fit every column and every
        # row at once (the same operations on the same costs), then pick
        c = flat.view(3, 3, n_by, n_bx)
        frac = _parabola(*(torch.cat([c[k], c[:, k]])
                           for k in range(3)))              # [6, Hb, Wb]
        zero = torch.zeros_like(frac[:1])
        fy = torch.where(by == 0, torch.gather(frac[:3], 0, bx + 1), zero)
        fx = torch.where(bx == 0, torch.gather(frac[3:], 0, by + 1), zero)
        mv = torch.cat([mv[0:1] + bx.to(torch.float32) + fx,
                        mv[1:2] + by.to(torch.float32) + fy])
    return mv


def seed_cell_mean(seed: torch.Tensor, f: int) -> torch.Tensor:
    """Mean of the temporal seed [2, Hb, Wb] over f x f cell groups ->
    [2, Hb/f, Wb/f]: the f*f terms summed one after another in row-major
    order from 0, then scaled by 1/f^2, which is XLA's order for tpufg's
    ``reshape(...).mean((2, 4))`` on the CPU (bitwise).  A fixed order on
    every device, so the kernel and plain paths agree bitwise too."""
    _, hb, wb = seed.shape
    cells = seed.to(torch.float32).reshape(2, hb // f, f, wb // f, f)
    acc = cells[:, :, 0, :, 0] + 0.0      # the reduction starts from 0
    for i in range(f):
        for j in range(f):
            if i or j:
                acc = acc + cells[:, :, i, :, j]
    return acc * (1.0 / (f * f))


def _reach(lvl: int, levels: int, base_radius: int,
           refine_radius: int) -> int:
    """The unseeded pyramid's reach at level ``lvl``, in its pixels."""
    return base_radius * 2 ** (levels - 1 - lvl) + \
        sum(refine_radius * 2 ** k for k in range(levels - 1 - lvl))


def _check_seeded_reach(levels: int, base_radius: int, refine_radius: int,
                        skip_finest_refine: int) -> None:
    """tpufg's check of each seeded refine warp's reach (the pyramid's own
    plus the temporal clamp at that level) against the warp's limit."""
    for lvl in range(levels - 2, -1, -1):
        if lvl < skip_finest_refine:
            continue
        reach = (_reach(lvl, levels, base_radius, refine_radius)
                 + TEMPORAL_CLAMP // 2 ** lvl)
        if reach > _WARP_REACH:
            raise ValueError(
                "temporal seeding: the level-"
                f"{lvl} refine warp reach ({reach} px) exceeds the "
                f"warp kernel's halo range ({_WARP_REACH} px); raise "
                "skip_finest_refine (the engine uses 1)")


def pyramid_motion_search(prev: torch.Tensor, curr: torch.Tensor,
                          levels: int = 3, base_radius: int = 4,
                          refine_radius: int = 2, block_size: int = 8,
                          grid: int = 16, skip_finest_refine: int = 0,
                          seed: torch.Tensor | None = None,
                          bias: float = 0.0) -> torch.Tensor:
    """``prev``/``curr``: planar [C, H, W] f32 with H, W divisible by
    ``grid * 2**(levels-1)``.  ``skip_finest_refine`` levels at the fine
    end are upsampled without a residual search (the engine's latency
    mode uses 1).  ``seed``: the temporal predictor, an MV field on the
    full-resolution lattice [2, H/grid, W/grid] (the previous pair's
    result); the search then returns seed cell means + residual.
    """
    _, h, w = prev.shape
    scale = grid * 2 ** (levels - 1)
    if h % scale or w % scale:
        raise ValueError(
            f"frame {h}x{w} must be divisible by grid*2^(levels-1) = {scale}")

    pyr = [(prev.to(torch.float32), curr.to(torch.float32))]
    for _ in range(levels - 1):
        p, q = pyr[-1]
        pyr.append((box_downsample2(p), box_downsample2(q)))

    p0, q0 = pyr[-1]
    seed_c = None
    if seed is not None:
        f = 2 ** (levels - 1)
        r_c = max(TEMPORAL_CLAMP // f, 1)
        # coarse-level pixels, clipped to the coarse warp's reach
        seed_c = torch.clamp(seed_cell_mean(seed, f) / float(f), -r_c, r_c)
        p0 = warp_blend_matmul(p0, p0, seed_c, block=grid,
                               search_radius=r_c, single=True)
    if _lattice_ok(base_radius, block_size, grid):
        mv = motion_search_lattice(p0, q0, grid=grid, block_size=block_size,
                                   search_radius=base_radius, bias=bias)
    else:
        mv = tiled_block_mv(p0, q0, block_size, base_radius, grid,
                            tile_h=64, tile_w=256)
    if seed_c is not None:
        mv = mv + seed_c    # residual + predictor, in coarse-level pixels
        _check_seeded_reach(levels, base_radius, refine_radius,
                            skip_finest_refine)
    for lvl in range(levels - 2, -1, -1):
        p_l, q_l = pyr[lvl]
        # same block lattice at the finer level: repeat 2x, values doubled
        mv = mv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0
        if lvl < skip_finest_refine:
            continue
        max_disp = _reach(lvl, levels, base_radius, refine_radius)
        if seed is not None:
            max_disp += TEMPORAL_CLAMP // 2 ** lvl
        # unseeded estimates are integers: the exact integer-offset warp;
        # seeded ones are fractional: the lerp
        warped = warp_blend_matmul(p_l, p_l, mv, block=grid,
                                   search_radius=max(int(max_disp), 1),
                                   single=True, integer_offsets=seed is None)
        if _lattice_ok(refine_radius, block_size, grid):
            res = motion_search_lattice(warped, q_l, grid=grid,
                                        block_size=block_size,
                                        search_radius=refine_radius,
                                        bias=bias)
        else:
            res = tiled_block_mv(warped, q_l, block_size, refine_radius,
                                 grid)
        mv = mv + res
    return mv
