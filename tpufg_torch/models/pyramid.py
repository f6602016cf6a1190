"""Hierarchical (coarse-to-fine) block-matching motion search.

Counterpart of ``tpufg/models/pyramid.py::pyramid_motion_search``, the
unseeded branch the engine runs: a 2x box pyramid (CUDA kernel
csrc/box2.cu), an exhaustive small-radius search at the coarsest level,
then per finer level a 2x MV upsample, an integer-offset warp of prev by
the estimate and a residual search.  Each search is the lattice search
while the radius keeps the candidate windows inside the grid cell, and
otherwise the per-pixel tiled search (CUDA kernel csrc/motion_tiled.cu)
subsampled at the block centres, as in tpufg (which passes no ``bias`` to
the tiled search).  Output: f32 [2, H/grid, W/grid] backward-flow MVs in
full-resolution pixels.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.motion import tiled_block_mv
from tpufg_torch.kernels.motion_xla import motion_search_lattice
from tpufg_torch.kernels.resize import box_downsample2, box_downsample2_plain
from tpufg_torch.kernels.warp_matmul import (warp_blend_matmul,
                                             warp_blend_matmul_plain)


def _lattice_ok(radius: int, block: int, grid: int) -> bool:
    """The lattice search applies when candidate windows stay in-cell."""
    off = (grid - block) // 2
    return off - radius >= 0 and off + block + radius <= grid


def pyramid_motion_search(prev: torch.Tensor, curr: torch.Tensor,
                          levels: int = 3, base_radius: int = 4,
                          refine_radius: int = 2, block_size: int = 8,
                          grid: int = 16, skip_finest_refine: int = 0,
                          seed: torch.Tensor | None = None,
                          bias: float = 0.0,
                          impl: str = "kernel") -> torch.Tensor:
    """``prev``/``curr``: planar [C, H, W] f32 with H, W divisible by
    ``grid * 2**(levels-1)``.  ``skip_finest_refine`` levels at the fine
    end are upsampled without a residual search (the engine's latency
    mode uses 1).  ``impl="plain"`` swaps the CUDA kernels (box filter,
    tiled search, refine warp) for their plain torch versions (for
    comparisons).
    """
    if seed is not None:
        raise NotImplementedError(
            "pyramid_motion_search: the temporal seed (--temporal-mv) is "
            "not yet ported")
    _, h, w = prev.shape
    scale = grid * 2 ** (levels - 1)
    if h % scale or w % scale:
        raise ValueError(
            f"frame {h}x{w} must be divisible by grid*2^(levels-1) = {scale}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    down = box_downsample2 if impl == "kernel" else box_downsample2_plain
    warp = warp_blend_matmul if impl == "kernel" else warp_blend_matmul_plain

    pyr = [(prev.to(torch.float32), curr.to(torch.float32))]
    for _ in range(levels - 1):
        p, q = pyr[-1]
        pyr.append((down(p), down(q)))

    p0, q0 = pyr[-1]
    if _lattice_ok(base_radius, block_size, grid):
        mv = motion_search_lattice(p0, q0, grid=grid, block_size=block_size,
                                   search_radius=base_radius, bias=bias)
    else:
        mv = tiled_block_mv(p0, q0, block_size, base_radius, grid, impl,
                            tile_h=64, tile_w=256)
    for lvl in range(levels - 2, -1, -1):
        p_l, q_l = pyr[lvl]
        # same block lattice at the finer level: repeat 2x, values doubled
        mv = mv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0
        if lvl < skip_finest_refine:
            continue
        max_disp = base_radius * 2 ** (levels - 1 - lvl) + \
            sum(refine_radius * 2 ** k for k in range(levels - 1 - lvl))
        # unseeded estimates are integers: the exact integer-offset warp
        warped = warp(p_l, p_l, mv, block=grid,
                      search_radius=max(int(max_disp), 1), single=True,
                      integer_offsets=True)
        if _lattice_ok(refine_radius, block_size, grid):
            res = motion_search_lattice(warped, q_l, grid=grid,
                                        block_size=block_size,
                                        search_radius=refine_radius,
                                        bias=bias)
        else:
            res = tiled_block_mv(warped, q_l, block_size, refine_radius,
                                 grid, impl)
        mv = mv + res
    return mv
