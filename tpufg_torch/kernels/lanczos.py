"""Separable Lanczos resample: planar float output, or fused with UNORM8
quantize and RGBA pack.

Counterpart of ``tpufg/kernels/lanczos.py`` (``lanczos_scale_fast`` and
``lanczos_scale_packed``).  The shader's 6x6 stencil with joint
renormalization over in-bounds taps factors exactly into two 1-D
resamples with per-axis renormalized weights (the weight is separable and
taps are dropped per axis).  Each axis is planned once on the host in
numpy, with the same math as tpufg's ``_axis_plan``: per output index,
``2a`` input indices and weights.  The TPU kernels bake those weights into
banded MXU matrices; here they are gather tables, read by the CUDA kernels
(csrc/lanczos_planar.cu, csrc/lanczos_packed.cu, one stencil in
csrc/lanczos_stencil.cuh) and by the plain torch version alike.  Both
kernels walk tiles of the output and form each horizontal tap sum once;
the tile sizes come from :func:`lanczos_plan`, which reads them off the
tables (:func:`axis_starts`), never off the scale.  The planar kernel
walks its channels in groups of up to four (:func:`planar_plan`,
:func:`channel_groups`).

Everything is computed in f32 whatever ``cfg.dtype`` or ``compute_dtype``
says: the reference's bf16 split-dot and +-1/2 centring exist for the
TPU's matrix unit, and f32 meets the bf16 contract (SSIM >= 0.999) with
margin.  ``lanczos_scale_fast`` takes ``compute_dtype`` for tpufg's
signature and ignores it; its output is in the input's dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain

_NP_PI = np.float32(3.14159265359)  # scale.comp:18
_KERNEL_A = (1, 2, 3, 4)            # taps = 2a instantiated in csrc
# the tile walk of both kernels: output columns (= threads) of a tile, the
# output rows per tile to choose from, the shared memory a block should
# stay within so that several blocks share an SM, the most it may use, and
# the most values a tile may stage per output pixel and four channels (the
# direct stencil loads 4 * taps^2 = 144 per pixel at a = 3, most of them
# from L1), for the packed and for the planar kernel
_TILE_W = 128
_TILE_ROWS = (32, 16, 8, 4, 2, 1)
_SMEM_TARGET = 32 * 1024
_MAX_SMEM = 227 * 1024
_STAGE_MAX = 16
_PLANAR_STAGE_MAX = 64
# csrc/lanczos_planar.cu: the channels a block may walk together (NCH is
# instantiated for 1 .. 4), most first, and the tile rows a group must reach
# within _SMEM_TARGET to be taken: a tall tile saves more (the 2a - 1 extra
# rows it stages are shared by more output rows) than a wide group does
_PLANAR_GROUPS = (4, 2, 1)
_PLANAR_MIN_ROWS = 16


def _np_lanczos_weight(x: np.ndarray, a: int) -> np.ndarray:
    """Lanczos-a weight in f32 (tpufg/kernels/lanczos.py:42, copied)."""
    x = x.astype(np.float32)
    px = _NP_PI * x
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.float32(a) * np.sin(px) * np.sin(px / np.float32(a)) / (px * px)
    return np.where(x == 0, np.float32(1.0), w).astype(np.float32)


def _np_axis_taps(in_size: int, out_size: int, a: int):
    """Per-output tap coordinates, deltas and validity in f32
    (tpufg/kernels/lanczos.py:55, copied)."""
    out_idx = np.arange(out_size, dtype=np.float32)
    uv = (out_idx + np.float32(0.5)) / np.float32(out_size)
    pixel_pos = uv * np.float32(in_size) - np.float32(0.5)
    fl = np.floor(pixel_pos)
    frac = (pixel_pos - fl).astype(np.float32)
    start = fl - np.float32(a - 1)
    k = np.arange(2 * a, dtype=np.float32)
    coords = start[:, None] + k[None, :]
    deltas = (k[None, :] - frac[:, None] - np.float32(a - 1)).astype(np.float32)
    valid = (coords >= 0) & (coords <= np.float32(in_size - 1))
    return coords.astype(np.int32), deltas, valid


def axis_taps(in_size: int, out_size: int, a: int):
    """Gather table of one axis: (idx int32 [out, 2a], w f32 [out, 2a]).

    Same weights as tpufg's ``_axis_plan`` bands: invalid taps weigh 0,
    the rest are divided by max(row sum, 1e-30).  Invalid indices are
    clamped into range so every gather stays in bounds (their weight is 0).
    """
    coords, deltas, valid = _np_axis_taps(in_size, out_size, a)
    w = _np_lanczos_weight(deltas, a)
    w = np.where(valid, w, np.float32(0.0)).astype(np.float32)
    wsum = np.sum(w, axis=1, keepdims=True, dtype=np.float32)
    w = (w / np.maximum(wsum, np.float32(1e-30))).astype(np.float32)
    idx = np.clip(coords, 0, in_size - 1).astype(np.int32)
    return idx, w


def axis_starts(in_size: int, out_size: int, a: int) -> np.ndarray:
    """The unclamped first tap of every output index, int32 [out]:
    ``axis_taps``'s index table is ``clip(start[:, None] + k, 0, in - 1)``."""
    coords, _, _ = _np_axis_taps(in_size, out_size, a)
    return np.ascontiguousarray(coords[:, 0])


def tile_span(starts: np.ndarray, tile: int, taps: int,
              align: int = 1) -> int:
    """The most input positions any tile of ``tile`` consecutive outputs
    touches: from its first output's first tap (rounded down to a multiple
    of ``align``) to its last output's last tap."""
    first = starts[::tile] // align * align
    last = starts[np.minimum(np.arange(tile - 1, len(starts) + tile - 1,
                                       tile), len(starts) - 1)]
    return int(np.max(last + taps - first))


class LanczosPlan(NamedTuple):
    """Launch geometry of the tile walk (csrc/lanczos_packed.cu,
    csrc/lanczos_planar.cu).  ``tile_rows`` = 0: the direct stencil (no
    tile fits in shared memory, or none pays)."""
    tile_w: int
    tile_rows: int
    rows_cap: int     # staged input rows a tile needs at most
    cols_cap: int     # staged input columns (a multiple of 4)
    smem: int         # dynamic shared memory bytes


def tile_smem_bytes(plan: LanczosPlan, taps: int, n_ch: int) -> int:
    """Dynamic shared memory of one block that walks ``n_ch`` channels over
    ``plan``'s tile: the staged f32 values, then per tile row its first
    virtual input row and its ``taps`` weights."""
    return 4 * (plan.rows_cap * n_ch * plan.cols_cap
                + plan.tile_rows * (1 + taps))


@functools.lru_cache(maxsize=64)
def lanczos_plan(in_h: int, in_w: int, out_h: int, out_w: int, a: int,
                 tile_w: int = _TILE_W, tile_rows: int | None = None,
                 n_ch: int = 4, stage_max: int = _STAGE_MAX) -> LanczosPlan:
    """The tile of the walk for a size pair and ``n_ch`` channels a block:
    ``tile_w`` output columns by the most output rows of ``_TILE_ROWS``
    whose staged input (rows x ``n_ch`` channels x columns, f32) and tap
    tables stay within ``_SMEM_TARGET`` bytes, else the most rows that fit
    in shared memory at all; the direct stencil where nothing fits or the
    tile would stage more than ``stage_max`` values per output pixel and
    four channels (strong downscales).  Every extent is read off the tap
    tables.  ``tile_rows`` forces a row count (for timing variants)."""
    taps = 2 * a
    xs, ys = axis_starts(in_w, out_w, a), axis_starts(in_h, out_h, a)
    cols_cap = -(-tile_span(xs, tile_w, taps, align=4) // 4) * 4
    plans = []
    for rows in (_TILE_ROWS if tile_rows is None else (tile_rows,)):
        plan = LanczosPlan(tile_w, rows, tile_span(ys, rows, taps), cols_cap,
                           0)
        plans.append(plan._replace(smem=tile_smem_bytes(plan, taps, n_ch)))
    if tile_rows is not None:
        return plans[0]
    plans = [p for p in plans
             if p.rows_cap * 4 * p.cols_cap <= stage_max * p.tile_rows * tile_w]
    for limit in (_SMEM_TARGET, _MAX_SMEM):
        for plan in plans:
            if plan.smem <= limit:
                return plan
    return LanczosPlan(tile_w, 0, 0, 0, 0)


def planar_plan(n_ch: int, in_h: int, in_w: int, out_h: int, out_w: int,
                a: int) -> tuple[int, LanczosPlan]:
    """The planar kernel's (channels per block, tile) for a stack of
    ``n_ch`` channels: the most channels of ``_PLANAR_GROUPS`` whose tile
    reaches ``_PLANAR_MIN_ROWS`` rows within ``_SMEM_TARGET`` (upscales:
    four), else one channel a block with the tallest tile that fits
    (downscales, whose tiles stage many input columns)."""
    for group in sorted({min(n_ch, g) for g in _PLANAR_GROUPS}, reverse=True):
        plan = lanczos_plan(in_h, in_w, out_h, out_w, a, n_ch=group,
                            stage_max=_PLANAR_STAGE_MAX)
        if plan.tile_rows >= _PLANAR_MIN_ROWS and plan.smem <= _SMEM_TARGET:
            break
    return group, plan


def channel_groups(n_ch: int, group: int) -> list:
    """How the planar tile walk covers ``n_ch`` channels, one launch per
    entry (first channel, blocks along z, channels per block): the full
    groups of ``group`` channels, then the remainder as one smaller group."""
    full, rem = divmod(n_ch, group)
    return ([(0, full, group)] if full else []) + \
        ([(full * group, 1, rem)] if rem else [])


@functools.lru_cache(maxsize=32)
def _device_starts(in_size: int, out_size: int, a: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(axis_starts(in_size, out_size, a)).to(device)


@functools.lru_cache(maxsize=32)
def _device_taps(in_size: int, out_size: int, a: int, device: torch.device):
    idx, w = axis_taps(in_size, out_size, a)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device))


def lanczos_scale(img: torch.Tensor, out_h: int, out_w: int,
                  a: int = 3) -> torch.Tensor:
    """Plain torch Lanczos-a resample: [C, H, W] -> f32 [C, out_h, out_w].

    Horizontal pass first, then vertical, each a sequential sum over the
    2a taps in table order — the order csrc/lanczos_stencil.cuh follows.
    """
    _, in_h, in_w = img.shape
    x = img.to(torch.float32)
    ix, wx = _device_taps(in_w, out_w, a, x.device)
    iy, wy = _device_taps(in_h, out_h, a, x.device)
    tmp = x[:, :, ix[:, 0]] * wx[:, 0]
    for k in range(1, 2 * a):
        tmp = tmp + x[:, :, ix[:, k]] * wx[:, k]
    out = tmp[:, iy[:, 0], :] * wy[:, 0, None]
    for k in range(1, 2 * a):
        out = out + tmp[:, iy[:, k], :] * wy[:, k, None]
    return out


def _check_kernel_args(name: str, a: int, out_h: int, out_w: int) -> None:
    if a not in _KERNEL_A:
        raise ValueError(f"{name}: the Lanczos kernels support a in "
                         f"{_KERNEL_A}, got {a}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"{name}: invalid output size {out_w}x{out_h}")


def lanczos_scale_fast_plain(img: torch.Tensor, out_h: int, out_w: int,
                             a: int = 3) -> torch.Tensor:
    """Plain torch version of :func:`lanczos_scale_fast`: the f32
    :func:`lanczos_scale`, cast to the input dtype at the end."""
    if img.dim() != 3:
        raise ValueError(f"lanczos_scale_fast needs [C, H, W], got "
                         f"{tuple(img.shape)}")
    return lanczos_scale(img, out_h, out_w, a).to(img.dtype)


def lanczos_scale_fast(img: torch.Tensor, out_h: int, out_w: int,
                       a: int = 3, compute_dtype=None) -> torch.Tensor:
    """Lanczos-``a`` resample of a planar frame stack.

    ``img``: [C, H, W] f32 or bf16, any C.  Returns [C, out_h, out_w] in
    the same dtype.  ``compute_dtype`` is accepted and ignored (f32
    throughout).  CUDA tensors run csrc/lanczos_planar.cu with the tile of
    :func:`planar_plan`, one launch per entry of :func:`channel_groups`
    (one launch in all where the plan names the direct stencil); CPU
    tensors take :func:`lanczos_scale_fast_plain`.  Both refuse the same
    dtypes, ``a`` and output sizes.
    """
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lanczos_scale_fast: expected float32 or bfloat16, "
                         f"got {img.dtype}")
    _check_kernel_args("lanczos_scale_fast", a, out_h, out_w)
    if use_plain(img):
        return lanczos_scale_fast_plain(img, out_h, out_w, a)
    img = img.contiguous()
    check_kernel_input(img, "lanczos_scale_fast", img.dtype, 3)
    n_ch, in_h, in_w = img.shape
    ix, wx = _device_taps(in_w, out_w, a, img.device)
    iy, wy = _device_taps(in_h, out_h, a, img.device)
    sx = _device_starts(in_w, out_w, a, img.device)
    sy = _device_starts(in_h, out_h, a, img.device)
    group, plan = planar_plan(n_ch, in_h, in_w, out_h, out_w, a)
    out = torch.empty((n_ch, out_h, out_w), dtype=img.dtype,
                      device=img.device)
    # the direct stencil loops over every channel in one launch
    work = channel_groups(n_ch, group) if plan.tile_rows else [(0, n_ch, 1)]
    for first, blocks, nch in work:
        launch("tpufg_lanczos_planar", img, img[first].data_ptr(),
               iy.data_ptr(), wy.data_ptr(), ix.data_ptr(), wx.data_ptr(),
               sy.data_ptr(), sx.data_ptr(), out[first].data_ptr(), blocks,
               nch, in_h, in_w, out_h, out_w, 2 * a,
               int(img.dtype == torch.bfloat16), plan.tile_w, plan.tile_rows,
               plan.rows_cap, plan.cols_cap,
               tile_smem_bytes(plan, 2 * a, nch),
               out=(out[first:first + blocks * nch],))
        lanczos_scale_fast.launches += 1
    return out


lanczos_scale_fast.launches = 0


def _wire(packed_i32: torch.Tensor, raw_i32: bool) -> torch.Tensor:
    if raw_i32:
        return packed_i32
    oh, ow = packed_i32.shape
    return packed_i32.view(torch.uint8).reshape(oh, ow, 4)


def lanczos_scale_packed_plain(img: torch.Tensor, out_h: int, out_w: int,
                               a: int = 3,
                               raw_i32: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`lanczos_scale_packed`: resample,
    clamp, *255, round half to even, and pack the four byte planes."""
    if img.dim() != 3 or img.shape[0] != 4:
        raise ValueError(f"packed scale needs [4, H, W], got "
                         f"{tuple(img.shape)}")
    out = lanczos_scale(img, out_h, out_w, a)
    q = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
    packed = q.permute(1, 2, 0).contiguous().view(torch.int32).squeeze(-1)
    return _wire(packed, raw_i32)


def lanczos_scale_packed(img: torch.Tensor, out_h: int, out_w: int,
                         a: int = 3, raw_i32: bool = False) -> torch.Tensor:
    """Lanczos resample fused with UNORM8 quantization and RGBA packing.

    ``img``: f32 [4, H, W] planar.  Returns uint8 [out_h, out_w, 4], or
    with ``raw_i32`` the same bytes as the packed int32 [out_h, out_w]
    wire.  CUDA tensors run csrc/lanczos_packed.cu with the tile of
    :func:`lanczos_plan`; CPU tensors take
    :func:`lanczos_scale_packed_plain`.
    """
    if use_plain(img):
        return lanczos_scale_packed_plain(img, out_h, out_w, a, raw_i32)
    check_kernel_input(img, "lanczos_scale_packed", torch.float32, 3)
    if img.shape[0] != 4:
        raise ValueError(f"packed scale needs 4 channels, got {img.shape[0]}")
    _check_kernel_args("lanczos_scale_packed", a, out_h, out_w)
    _, in_h, in_w = img.shape
    ix, wx = _device_taps(in_w, out_w, a, img.device)
    iy, wy = _device_taps(in_h, out_h, a, img.device)
    sx = _device_starts(in_w, out_w, a, img.device)
    sy = _device_starts(in_h, out_h, a, img.device)
    plan = lanczos_plan(in_h, in_w, out_h, out_w, a)
    out = torch.empty((out_h, out_w), dtype=torch.int32, device=img.device)
    launch("tpufg_lanczos_packed", img, img.data_ptr(), iy.data_ptr(),
           wy.data_ptr(), ix.data_ptr(), wx.data_ptr(), sy.data_ptr(),
           sx.data_ptr(), out.data_ptr(), in_h, in_w, out_h, out_w, 2 * a,
           *plan, out=(out,))
    lanczos_scale_packed.launches += 1
    return _wire(out, raw_i32)


lanczos_scale_packed.launches = 0
