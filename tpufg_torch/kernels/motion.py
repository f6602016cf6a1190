"""Exhaustive block-matching motion search: every pixel, or the MV
lattice's site rows only.

Counterpart of ``tpufg/kernels/motion.py`` (``motion_search_tiled`` and
``motion_search_sites``, the Pallas kernels of ``motion.comp``).  For
every output pixel p and candidate displacement d in [-r, r]^2 the cost is
the sum over the b x b block anchored at p - b/2 of

    D_d(q) = sqrt(sum_c (curr[c, q] - prev[c, clamp(q + d)])^2) * valid(q)

(out-of-image block pixels q weigh 0, the prev fetch clamps to the edge),
and the MV is the first minimum of the dy-outer / dx-inner scan from -r to
r with a strict ``<`` (a constant pair gives (-r, -r)).

Bitwise contract, shared by tpufg, the plain versions below and the CUDA
kernels (csrc/motion_sites.cu, csrc/motion_tiled.cu): the channel sum is
``((d0*d0 + d1*d1) + d2*d2) + d3*d3`` with one rounding per operation,
then a correctly rounded sqrt, then the mask; the box sum is either the
separable order (the b block rows first, each added in turn, then the b
columns of that row sum) or, with ``exact_box``, one running sum over the
block in y-outer / x-inner order.  tpufg's tiling (``tile_h``,
``tile_w``, ``dx_chunk``) does not change its result, so the port accepts
those arguments and ignores them.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import (check_kernel_input, launch,
                                        round_up, use_plain)

F32 = torch.float32

# CUDA kernels: threads per group (= block-pixel columns a block scores),
# the channel counts the kernels take (RGBA, and RGB when the engine drops a
# constant alpha), and the dynamic shared memory a block may ask for on
# sm_90.  csrc/motion_sites.cu: the dy candidates it scores together.
# csrc/motion_tiled.cu: the block sizes it has compiled in, with their
# output rows per tile, the rows of any other block size, and the most
# 128-thread groups a block runs
_THREADS = 128
_KERNEL_CH = (3, 4)
_MAX_SMEM = 227 * 1024
_SITES_DY_BLOCK = 4
_TILED_FAST_B = (8, 12, 16)
_TILED_ROWS_FAST = 16
_TILED_ROWS_ANY = 8
_TILED_MAX_GROUPS = 5


def sites_tile_w(search_radius: int, n_ch: int = 4, b: int = 8,
                 budget_bytes: int = 12 << 20) -> int:
    """tpufg's sites tile width for a radius (``tpufg/kernels/motion.py::
    sites_tile_w``, copied: tpufg's module imports JAX).  The engine passes
    it on as tpufg does; the port's result does not depend on it."""
    n_o = 2 * int(search_radius) + b
    for tw in range(1024, 127, -128):
        pspan = round_up(tw + b - 1 + 2 * int(search_radius), 128)
        cspan = round_up(tw + b - 1 + b // 2, 128)
        if n_ch * 8 * (n_o * pspan + b * cspan) * 4 <= budget_bytes:
            return tw
    return 128


def _check_chunk(dx_chunk: int, r: int) -> None:
    if dx_chunk and (2 * r + 1) % dx_chunk:
        raise ValueError(f"dx_chunk {dx_chunk} must divide 2r+1 = {2*r+1}")


def _check_pair(prev: torch.Tensor, curr: torch.Tensor) -> None:
    if prev.dim() != 3 or prev.shape != curr.shape:
        raise ValueError(f"motion search takes two [C, H, W] frames of one "
                         f"shape, got {tuple(prev.shape)} and "
                         f"{tuple(curr.shape)}")


def _scan(curr_ext: torch.Tensor, prev_rows: Callable[[int], torch.Tensor],
          mask: torch.Tensor, r: int,
          box: Callable[[torch.Tensor], torch.Tensor],
          sqrt: bool = True) -> torch.Tensor:
    """The candidate loop shared by the plain versions and
    ``motion_search_xla``.

    ``curr_ext`` [C, R, E]: the block pixels (zero outside the image);
    ``prev_rows(dy)`` [C, R, E + 2r]: prev at those rows moved by dy, with
    r clamped columns on each side; ``mask`` broadcasts against [R, E];
    ``box`` reduces a distance field [R, E] to the costs; ``sqrt=False``
    keeps the squared distance (the "ssd" metric).  One candidate at a time
    (never all (2r+1)^2 stacked), dy outer, dx inner, strict ``<``.
    Returns f32 [2, *cost.shape] (dx, dy).
    """
    n_ch, _, e = curr_ext.shape
    n = 2 * r + 1
    best = best_k = None
    k = 0
    for dy in range(-r, r + 1):
        rows = prev_rows(dy)
        for dx in range(-r, r + 1):
            win = rows[:, :, r + dx:r + dx + e]
            d = curr_ext[0] - win[0]
            acc = d * d
            for c in range(1, n_ch):
                d = curr_ext[c] - win[c]
                acc = acc + d * d
            cost = box((torch.sqrt(acc) if sqrt else acc) * mask)
            if best is None:
                # tpufg's start: cost 1e10 at (dx, dy) = (0, 0)
                best = torch.full_like(cost, 1e10)
                best_k = torch.full(cost.shape, r * n + r, dtype=torch.int64,
                                    device=cost.device)
            upd = cost < best
            best = torch.where(upd, cost, best)
            best_k = torch.where(upd, k, best_k)
            k += 1
    return torch.stack([best_k % n - r, best_k // n - r]).to(F32)


def _separable_box(b: int, out_w: int) -> Callable:
    """Sliding b x b box on [R, E] (R = rows + b - 1): the b rows first,
    then the b columns of the row sum."""
    def box(dist: torch.Tensor) -> torch.Tensor:
        out_h = dist.shape[0] - b + 1
        rowsum = dist[0:out_h]
        for ky in range(1, b):
            rowsum = rowsum + dist[ky:ky + out_h]
        cost = rowsum[:, 0:out_w]
        for kx in range(1, b):
            cost = cost + rowsum[:, kx:kx + out_w]
        return cost
    return box


def _exact_box(b: int, out_w: int) -> Callable:
    """Sliding b x b box on [R, E], one running sum in y-outer / x-inner
    order from the block's first pixel (motion.comp's loop)."""
    def box(dist: torch.Tensor) -> torch.Tensor:
        out_h = dist.shape[0] - b + 1
        cost = dist[0:out_h, 0:out_w]
        for ky in range(b):
            for kx in range(b):
                if ky or kx:
                    cost = cost + dist[ky:ky + out_h, kx:kx + out_w]
        return cost
    return box


def motion_search_tiled_plain(prev: torch.Tensor, curr: torch.Tensor,
                              block_size: int = 8, search_radius: int = 16,
                              exact_box: bool = True) -> torch.Tensor:
    """Plain torch version of :func:`motion_search_tiled`: planar
    [C, H, W] -> f32 [2, H, W] (dx, dy) at every pixel."""
    return pixel_search(prev, curr, block_size, search_radius, exact_box)


def pixel_search(prev: torch.Tensor, curr: torch.Tensor, block_size: int,
                 search_radius: int, exact_box: bool,
                 sqrt: bool = True) -> torch.Tensor:
    """The per-pixel search of :func:`motion_search_tiled_plain`, and of
    ``motion_search_xla`` (separable box, ``sqrt`` per metric)."""
    _check_pair(prev, curr)
    n_ch, h, w = prev.shape
    b, r = int(block_size), int(search_radius)
    a = b // 2
    # block pixel (i, j) of the extended grid is image pixel (i - a, j - a)
    cur = F.pad(curr.to(F32), (a, b - 1 - a, a, b - 1 - a))
    pre = F.pad(prev.to(F32)[None], (r + a, r + b - 1 - a, r + a,
                                     r + b - 1 - a), mode="replicate")[0]
    ys = torch.arange(h + b - 1, device=prev.device) - a
    xs = torch.arange(w + b - 1, device=prev.device) - a
    mask = (((ys >= 0) & (ys < h))[:, None]
            & ((xs >= 0) & (xs < w))[None, :]).to(F32)
    box = _exact_box(b, w) if exact_box else _separable_box(b, w)
    return _scan(cur, lambda dy: pre[:, r + dy:r + dy + h + b - 1], mask, r,
                 box, sqrt)


def motion_search_sites_plain(prev: torch.Tensor, curr: torch.Tensor,
                              block_size: int = 8, search_radius: int = 16,
                              grid: int = 16) -> torch.Tensor:
    """Plain torch version of :func:`motion_search_sites`: planar
    [C, H, W] (H % grid == 0) -> f32 [2, H/grid, W], the per-pixel field
    at the site rows grid/2 + grid*k (separable box)."""
    _check_pair(prev, curr)
    n_ch, h, w = prev.shape
    b, r, g = int(block_size), int(search_radius), int(grid)
    a = b // 2
    m = h // g
    # block rows of site k: g*k + g/2 - a + u, u = 0..b-1, all in the image
    rows = (torch.arange(m, device=prev.device)[:, None] * g + g // 2 - a
            + torch.arange(b, device=prev.device)[None, :]).reshape(-1)
    cur = F.pad(curr.to(F32)[:, rows], (a, b - 1 - a))
    pre = F.pad(prev.to(F32), (r + a, r + b - 1 - a), mode="replicate")
    xs = torch.arange(w + b - 1, device=prev.device) - a
    mask = ((xs >= 0) & (xs < w)).to(F32)[None, :]

    def prev_rows(dy: int) -> torch.Tensor:
        return pre[:, torch.clamp(rows + dy, 0, h - 1)]

    def box(dist: torch.Tensor) -> torch.Tensor:
        d = dist.reshape(m, b, w + b - 1)
        rowsum = d[:, 0]
        for u in range(1, b):
            rowsum = rowsum + d[:, u]
        cost = rowsum[:, 0:w]
        for kx in range(1, b):
            cost = cost + rowsum[:, kx:kx + w]
        return cost

    return _scan(cur, prev_rows, mask, r, box)


def _kernel_operands(name: str, prev: torch.Tensor, curr: torch.Tensor):
    """f32 contiguous copies of a CUDA pair, validated for the launcher."""
    p = prev.to(F32).contiguous()
    c = curr.to(F32).contiguous()
    check_kernel_input(p, name, F32, 3)
    check_kernel_input(c, name, F32, 3)
    if p.device != c.device:
        raise ValueError(f"{name}: prev on {p.device}, curr on {c.device}")
    if p.shape[0] not in _KERNEL_CH:
        raise ValueError(f"{name}: the kernel takes {_KERNEL_CH} channels, "
                         f"got {p.shape[0]}")
    return p, c


def _check_smem(name: str, nbytes: int) -> None:
    if nbytes > _MAX_SMEM:
        raise ValueError(f"{name}: needs {nbytes} bytes of shared memory per "
                         f"block (limit {_MAX_SMEM}); lower the block size "
                         "or the search radius")


def sites_smem_bytes(search_radius: int,
                     dy_block: int = _SITES_DY_BLOCK) -> int:
    """Dynamic shared memory of one csrc/motion_sites.cu block that scores
    ``dy_block`` dy candidates together: the 8 + dy_block - 1 prev rows they
    read (one float4 per pixel, whatever the channel count), and their
    double-buffered row sums."""
    return (16 * (8 + dy_block - 1) * (_THREADS + 2 * search_radius)
            + 2 * dy_block * _THREADS * 4)


def sites_plan(search_radius: int) -> tuple[int, int]:
    """(dy candidates scored together, shared memory bytes) of the
    csrc/motion_sites.cu launch for a radius.  The split is compiled into
    the kernel; the bytes exceed the limit when the staged rows of a radius
    do not fit (the wrapper raises)."""
    return _SITES_DY_BLOCK, sites_smem_bytes(search_radius)


def tiled_smem_bytes(block_size: int, search_radius: int, exact_box: bool,
                     rows: int, groups: int) -> int:
    """Dynamic shared memory of one csrc/motion_tiled.cu block of ``groups``
    128-thread groups on a tile of ``rows`` output rows: curr's block
    pixels and the prev rows of one dy (one float4 per pixel), each group's
    double-buffered distances (exact box) or row sums (separable), and 16
    bytes a float4 read past the last row may touch."""
    ext = rows + block_size - 1
    buf = ext if exact_box else rows
    return (16 * ext * (2 * _THREADS + 2 * search_radius)
            + groups * 2 * buf * _THREADS * 4 + 16)


def tiled_plan(block_size: int, search_radius: int,
               exact_box: bool) -> tuple[int, int, int]:
    """(output rows per tile, groups per block, shared memory bytes) of the
    csrc/motion_tiled.cu launch for a block size, radius and box order: the
    taller tile where the block size is compiled in, and the most groups
    that fit in shared memory; the shorter tile otherwise.  The bytes
    exceed the limit when nothing fits (the wrapper raises)."""
    tall = [_TILED_ROWS_FAST] if block_size in _TILED_FAST_B else []
    for rows in (*tall, _TILED_ROWS_ANY):
        for groups in range(_TILED_MAX_GROUPS, 0, -1):
            smem = tiled_smem_bytes(block_size, search_radius, exact_box,
                                    rows, groups)
            if smem <= _MAX_SMEM:
                return rows, groups, smem
    return _TILED_ROWS_ANY, 1, smem


def motion_search_sites(prev: torch.Tensor, curr: torch.Tensor,
                        block_size: int = 8, search_radius: int = 16,
                        grid: int = 16, tile_w: int = 512,
                        interpret: bool | None = None,
                        dx_chunk: int = 3) -> torch.Tensor:
    """Exhaustive block matching at the MV lattice's site rows.

    ``prev``/``curr``: planar [C, H, W] (computed in f32), H % grid == 0.
    Returns f32 [2, H/grid, W]: the per-pixel field (separable box) at rows
    grid/2 + grid*k, every column; the engine keeps columns grid/2::grid.
    Supports block_size=8, grid=16, as tpufg does.  ``tile_w``,
    ``interpret`` and ``dx_chunk`` are tpufg's tuning arguments; only
    ``dx_chunk``'s divisibility is checked.  CUDA tensors run
    csrc/motion_sites.cu; CPU tensors take
    :func:`motion_search_sites_plain`.
    """
    _check_pair(prev, curr)
    n_ch, h, w = prev.shape
    b, r, g = int(block_size), int(search_radius), int(grid)
    if b != 8 or g != 16:
        raise ValueError("motion_search_sites supports block_size=8, "
                         f"grid=16 (got b={b}, grid={g})")
    if h % g:
        raise ValueError(f"H={h} must be divisible by grid={g}")
    _check_chunk(dx_chunk, r)
    if use_plain(prev):
        return motion_search_sites_plain(prev, curr, b, r, g)
    p, c = _kernel_operands("motion_search_sites", prev, curr)
    dy_block, smem = sites_plan(r)
    _check_smem("motion_search_sites", smem)
    out = torch.empty((2, h // g, w), dtype=F32, device=p.device)
    launch("tpufg_motion_sites", p, p.data_ptr(), c.data_ptr(),
           out.data_ptr(), n_ch, h, w, r, dy_block, smem, out=(out,))
    motion_search_sites.launches += 1
    return out


def motion_search_tiled(prev: torch.Tensor, curr: torch.Tensor,
                        block_size: int = 8, search_radius: int = 16,
                        tile_h: int = 128, tile_w: int = 128,
                        interpret: bool | None = None,
                        exact_box: bool = True,
                        dx_chunk: int = 0) -> torch.Tensor:
    """Exhaustive block matching at every pixel.

    ``prev``/``curr``: planar [C, H, W] (computed in f32).  Returns f32
    [2, H, W]: plane 0 = dx, plane 1 = dy, in pixels (backward flow:
    curr[q] ~= prev[q + mv]).  ``exact_box`` selects the y-outer / x-inner
    box sum, else the separable one.  ``tile_h``, ``tile_w``,
    ``interpret`` and ``dx_chunk`` are tpufg's tuning arguments; only
    ``dx_chunk``'s divisibility is checked.  CUDA tensors run
    csrc/motion_tiled.cu with the tile height and the number of thread
    groups of :func:`tiled_plan`; CPU tensors take
    :func:`motion_search_tiled_plain`.
    """
    _check_pair(prev, curr)
    n_ch, h, w = prev.shape
    b, r = int(block_size), int(search_radius)
    _check_chunk(dx_chunk, r)
    if use_plain(prev):
        return motion_search_tiled_plain(prev, curr, b, r, exact_box)
    p, c = _kernel_operands("motion_search_tiled", prev, curr)
    if b >= _THREADS:
        raise ValueError(f"motion_search_tiled: block_size {b} must be below "
                         f"{_THREADS} on the card")
    rows, groups, smem = tiled_plan(b, r, bool(exact_box))
    _check_smem("motion_search_tiled", smem)
    out = torch.empty((2, h, w), dtype=F32, device=p.device)
    launch("tpufg_motion_tiled", p, p.data_ptr(), c.data_ptr(),
           out.data_ptr(), n_ch, h, w, b, r, int(bool(exact_box)), rows,
           groups, smem, out=(out,))
    motion_search_tiled.launches += 1
    return out


motion_search_sites.launches = 0
motion_search_tiled.launches = 0


def tiled_block_mv(prev: torch.Tensor, curr: torch.Tensor, block_size: int,
                   search_radius: int, grid: int = 16,
                   **tiles) -> torch.Tensor:
    """The per-pixel separable search subsampled at the block centres of
    the ``grid``-px lattice: f32 [2, H/grid, W/grid].  Config 3 runs it at
    block sizes other than 8, the pyramid as its fallback; tpufg passes no
    ``mv_bias`` to either.  ``tiles`` are tpufg's tiling arguments."""
    mv = motion_search_tiled(prev, curr, block_size=block_size,
                             search_radius=search_radius, exact_box=False,
                             **tiles)
    return mv[:, grid // 2::grid, grid // 2::grid]
