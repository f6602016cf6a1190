"""Motion-compensated warp and blend: CUDA kernels and their plain versions.

Counterpart of ``tpufg/kernels/warp_matmul.py::warp_blend_matmul``.  The
TPU moves pixels with one-hot shift matmuls; the plain version here
(:func:`warp_blend_matmul_plain`) gathers the same taps, and the CUDA
kernels compute the same values bitwise: csrc/warp_matmul.cu (the tile
walk of csrc/warp_tile.cuh) for block MVs, csrc/warp_obmc.cu for the
per-pixel warp (``bilinear``), csrc/warp_epilogue.cu for the occlusion
blend and the MC fallback.  On a CPU tensor the wrapper
:func:`warp_blend_matmul` runs the plain version; on a CUDA tensor it
launches the kernels or raises.  Three kinds of offset:

- ``integer_offsets=True`` (the pyramid's refine warp; the engine's t = 0.5
  blend of pyramid MVs): each block moves by whole pixels.  One-hot weights
  of exactly 0 and 1 select a single value, so one gather reproduces the
  TPU bit for bit, provided the value domain around the move is reproduced
  too.  Single mode moves centred values and un-centres them,
  ``fl(fl(x - 0.5) + 0.5)``, which is not always ``x``; with ``u8_exact``
  (the engine's blend) values move as centred integer codes
  ``round(255 x) - 128`` and come back as ``(o + 128) * fl(1/255)`` (tpufg
  writes ``/ 255``, which XLA compiles into that multiply; see
  ``kernels/convert.py``).
- ``integer_offsets=False`` (exhaustive MVs, t != 0.5, odd warp ranges):
  the offset ``o = mv * scale`` splits into ``floor(o)`` and a fraction f
  (both in f32, as tpufg computes them), and the centred values
  ``x - 0.5``, cast to ``dtype``, are lerped horizontally then vertically:
  ``a * (1 - f) + b * f`` with the weights ``f`` and ``1 - f`` rounded to
  ``dtype``, each lerp computed in f32 and rounded to ``dtype`` (the
  rounding of tpufg's one-hot matmul and its vertical select).
  ``u8_exact`` has no effect here, as in tpufg.
- ``bilinear=True`` (``--mv-grid 1``, the per-pixel or OBMC warp, block
  g a multiple of 8): each lattice row j of offsets is resized along x to
  one offset per column (``jax.image.resize``'s linear weights,
  ``kernels/resize.py``), and "band" j warps the rows around its sites,
  image rows ``j*g - g/2 .. j*g + 3g/2``, by those per-column offsets with
  the fractional lerp above.  Output row ``j*g + g/2 + k`` (k < g) blends
  band j and band j + 1 in ``dtype``, ``a * (1 - w) + b * w`` with
  ``w = fl((k + 0.5) / g)`` rounded to ``dtype``, each product and the sum
  rounded to ``dtype``; the first and last g/2 rows come from the edge
  bands alone.

Taps clamp to the frame's edge, and a sample whose displaced position
falls outside ``[-0.5, W - 0.5] x [-0.5, H - 0.5]`` is blanked in the
blend (interpolate.comp's uv-outside-[0,1] rule); in the per-pixel warp
the displacement of that test is the MV field resized to every pixel in
both axes.  W and H are those of the frame given here — in the engine,
the 64-lattice-padded frame.  tpufg edge-pads W to a multiple of 128 for
its matmuls; the port pads only where the padded columns reach the result
(the per-pixel warp's offsets and the fallback's cell means are resized
over them), and the clamped gather needs no pad elsewhere.

The blend options (blend mode only, as in tpufg): ``occlusion`` shifts the
blend toward the temporally closer side where the warped pair disagrees
(the channel mean of ``|wp - wc|``); ``mc_fallback`` falls back to a
crossfade per 8x8 cell where the warped pair disagrees more than the
unmoved pair (RGB means, cell means resized back to every pixel).  The
kernel path writes the warped pair and the two masks ([2C + 2, H, W]) and
:func:`warp_epilogue` reads them; the per-pixel warp also writes the
fallback's cell means in the same launch.  Sums run in a fixed order
(channels in turn; a cell's rows left to right, then the row sums top to
bottom), one rounding per operation; XLA sums and contracts in its own
order, so the options' output sits within 1e-6 of tpufg's on [0, 1].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import (check_kernel_input, launch,
                                        round_up, use_plain)
from tpufg_torch.kernels.convert import INV255
from tpufg_torch.kernels.resize import linear_taps, resize_linear

F32 = torch.float32

# occlusion-blend response: k = 0 below OCC_D0 mean-abs disagreement
# ([0, 1] units), saturating to a hard side-pick over 1/OCC_SLOPE (tpufg's
# constants, tpufg/kernels/warp_matmul.py)
OCC_D0 = 0.08
OCC_SLOPE = 8.0
# MC -> crossfade fallback: rel = D_mc / (D_cf + FB_FLOOR) per cell, full
# MC at rel <= FB_LO, full crossfade at rel >= FB_HI, linear between
FB_FLOOR = 0.015
FB_LO = 0.5
FB_HI = 1.0
FB_CELL = 8         # the fallback's cells are FB_CELL x FB_CELL pixels


def _check_reach(eff_r: int, g: int) -> None:
    """tpufg's limit on the per-frame reach ``eff_r``: its band halo must
    fit the warp's 256-column window."""
    halo = round_up(eff_r + 2, 8)
    while (2 * halo) % g:
        halo += 8
    if halo > 63:
        raise ValueError("search radius too large for the 256-col window")


def _col_pad(w: int, bilinear: bool, mc_fallback: bool) -> int:
    """The columns of tpufg's edge pad to a multiple of 128 that reach the
    result: the per-pixel warp's offsets and the fallback's cell means are
    resized over them.  0 where nothing reads them."""
    if not (bilinear or mc_fallback) or w % 128 == 0:
        return 0
    return round_up(w, 128) - w


def _check_options(prev: torch.Tensor, mv: torch.Tensor, factor: float,
                   block: int, search_radius: int, single: bool,
                   dtype: torch.dtype, integer_offsets: bool, bilinear: bool,
                   mc_fallback: bool,
                   crop: tuple[int, int] | None) -> tuple[int, int]:
    """The refusals both forms share (tpufg's): the moving type, the block
    lattice, the MV shape, the reach limit, the per-pixel warp's needs and
    a crop past the frame.  Returns the output's (rows, columns)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"warp dtype must be f32 or bf16, got {dtype}")
    _, h, w = prev.shape
    g, r = int(block), int(search_radius)
    if h % g or w % g:
        raise ValueError(f"frame {h}x{w}: H%{g} and W%{g} must be 0")
    n_by, n_bx = h // g, w // g
    if tuple(mv.shape) != (2, n_by, n_bx):
        raise ValueError(f"mv shape {tuple(mv.shape)} != (2, {n_by}, {n_bx})")
    eff_r = r if single else max(1, int(math.ceil(
        r * max(float(factor), 1.0 - float(factor)))))
    _check_reach(eff_r, g)
    if bilinear and integer_offsets:
        raise ValueError("bilinear MV offsets are fractional by nature")
    if bilinear and g % 8:
        raise ValueError(f"bilinear warp needs block % 8 == 0, got {g}")
    pw = _col_pad(w, bilinear, mc_fallback and not single)
    if pw % g:
        # tpufg pads the lattice by whole blocks: the shapes then disagree
        raise ValueError(f"mv shape {(2, n_by, n_bx + pw // g)} != "
                         f"(2, {n_by}, {(w + pw) // g})")
    out_h, out_w = (h, w) if crop is None else (int(crop[0]), int(crop[1]))
    if not (0 < out_h <= h and 0 < out_w <= w):
        raise ValueError(f"crop {crop} outside the {h}x{w} frame")
    return out_h, out_w


def _blend_weights(factor: float) -> tuple[float, float]:
    """The f32 blend weights (t, 1 - t) as Python floats (a CUDA scalar
    tensor made from the host would synchronise the stream)."""
    return (float(np.float32(factor)),
            float(np.float32(1.0) - np.float32(factor)))


def _pad_columns(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
                 pw: int, g: int):
    """tpufg's edge pad of the frames by ``pw`` columns and of the MV
    lattice by ``pw / g`` blocks."""
    def pad(x: torch.Tensor, n: int) -> torch.Tensor:
        return F.pad(x, (0, n), mode="replicate")
    return pad(prev, pw), pad(curr, pw), pad(mv, pw // g)


def _block_offsets(md: torch.Tensor, scale: float, g: int) -> torch.Tensor:
    """Per-pixel f32 offset along one axis: block values ``md * scale``
    repeated over [n_by*g, n_bx*g] pixels."""
    o = md * scale
    return o.repeat_interleave(g, dim=0).repeat_interleave(g, dim=1)


def _gather(v: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """v [C, H, W] at per-pixel integer positions ``rows``, ``cols``
    (broadcasting to [H, W]), clamped to the edge."""
    c, h, w = v.shape
    flat = (torch.clamp(rows, 0, h - 1) * w
            + torch.clamp(cols, 0, w - 1)).reshape(-1)
    return v.reshape(c, h * w)[:, flat].reshape(c, h, w)


def _hlerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """The horizontal lerp ``a * (1 - f) + b * f`` of ``dtype`` operands
    and weight ``f``, as tpufg's one-hot matmul computes it: ``1 - f``
    rounded to ``dtype``, the sum in f32 (one rounding per operation), the
    result rounded once to ``dtype``."""
    return (a.to(F32) * (1.0 - f).to(F32) + b.to(F32) * f.to(F32)).to(dtype)


def _frac_warp(v: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The fractional warp of ``dtype`` values v [C, H, W] by per-pixel f32
    offsets [H, W]: the horizontal lerp of two taps on two tap rows, then
    the vertical lerp elementwise in ``dtype`` (each product and the sum
    rounded to ``dtype``, as tpufg's select computes it)."""
    _, h, w = v.shape
    ys = torch.arange(h, device=v.device)[:, None]
    xs = torch.arange(w, device=v.device)[None, :]
    fy, fx = torch.floor(oy), torch.floor(ox)
    rows = ys + fy.to(torch.int64)
    cols = xs + fx.to(torch.int64)
    wy, wx = (oy - fy).to(dtype), (ox - fx).to(dtype)

    def row_lerp(at: torch.Tensor) -> torch.Tensor:
        return _hlerp(_gather(v, at, cols), _gather(v, at, cols + 1), wx,
                      dtype)

    return row_lerp(rows) * (1.0 - wy) + row_lerp(rows + 1) * wy


@functools.lru_cache(maxsize=32)
def _obmc_rows(h: int, g: int, dtype: torch.dtype, device: torch.device):
    """Per output row of the per-pixel warp: the two bands it reads (ja,
    jb), band jb's weight ``fl((k + 0.5) / g)`` in ``dtype``, and whether
    the row lies in the first or last g/2 rows (band ja alone)."""
    n_by = h // g
    y = np.arange(h)
    k = (y - g // 2) % g
    j = (y - g // 2) // g
    alone = (y < g // 2) | (y >= n_by * g - g // 2)
    ja = np.clip(j, 0, n_by - 1)
    jb = np.where(alone, ja, np.minimum(j + 1, n_by - 1))
    wy = (k.astype(np.float32) + np.float32(0.5)) / np.float32(g)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dev(ja.astype(np.int64)), dev(jb.astype(np.int64)),
            dev(wy.astype(np.float32)).to(dtype).view(h, 1),
            dev(alone).view(h, 1))


def _obmc_warp(v: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor, g: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The per-pixel warp of ``dtype`` values v [C, H, W] by per-column
    offsets ox, oy [H/g, W] (one row per band): each output row blends its
    two bands' fractional warps in ``dtype``."""
    _, h, _ = v.shape
    ja, jb, wy, alone = _obmc_rows(h, g, dtype, v.device)
    va = _frac_warp(v, ox[ja], oy[ja], dtype)
    vb = _frac_warp(v, ox[jb], oy[jb], dtype)
    return torch.where(alone, va, va * (1.0 - wy) + vb * wy)


def obmc_offsets(mv: torch.Tensor, r: float, scales, w: int) -> torch.Tensor:
    """The per-pixel warp's per-column offsets: for each scale s the MVs
    clipped to +-r times s, resized along x to ``w`` columns ([2 *
    len(scales), H/g, w] f32: dx, dy per scale)."""
    md = torch.clamp(mv.to(F32), -r, r)
    stacked = torch.cat([md * s for s in scales])
    return resize_linear(stacked, (stacked.shape[0], stacked.shape[1], w))


def _move(x: torch.Tensor, md: torch.Tensor, scale: float, g: int,
          dtype: torch.dtype, integer: bool, int_domain: bool,
          offs: torch.Tensor | None) -> torch.Tensor:
    """One side of the warp, f32 [C, H, W] out: into the domain the TPU
    moves values in, the warp by the clipped block MVs ``md`` times
    ``scale`` (or, given ``offs``, the per-pixel warp's per-column offsets
    dx, dy), and back."""
    x = x.to(F32)
    v = (torch.round(x * 255.0) - 128.0 if int_domain else x - 0.5).to(dtype)
    if offs is not None:
        o = _obmc_warp(v, offs[0], offs[1], g, dtype)
    else:
        ox = _block_offsets(md[0], scale, g)
        oy = _block_offsets(md[1], scale, g)
        if integer:
            _, h, w = v.shape
            o = _gather(v, torch.arange(h, device=v.device)[:, None]
                        + torch.floor(oy).to(torch.int64),
                        torch.arange(w, device=v.device)[None, :]
                        + torch.floor(ox).to(torch.int64))
        else:
            o = _frac_warp(v, ox, oy, dtype)
    o = o.to(F32)
    if int_domain:
        return (o + 128.0) * INV255
    return o + 0.5


def _oob_mask(md: torch.Tensor, scale: float, g: int, h: int, w: int,
              valid_w: int, offs: torch.Tensor | None) -> torch.Tensor:
    """f32 [1, H, W]: 1 where the sample point of each pixel lies in
    [-0.5, valid_w - 0.5] x [-0.5, H - 0.5].  The per-pixel warp's
    displacement is the clipped MV field times ``scale`` resized to every
    pixel (x first, ``offs``: its per-column rows; then y)."""
    if offs is not None:
        fx = resize_linear(offs[0], (h, w))
        fy = resize_linear(offs[1], (h, w))
    else:
        fx = _block_offsets(md[0], scale, g)
        fy = _block_offsets(md[1], scale, g)
    px = torch.arange(w, device=fx.device, dtype=F32)[None, :] + fx
    py = torch.arange(h, device=fx.device, dtype=F32)[:, None] + fy
    ok = (px >= -0.5) & (px <= valid_w - 0.5) & (py >= -0.5) & (py <= h - 0.5)
    return ok.to(F32)[None]


def warp_pair_plain(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
                    factor: float = 0.5, block: int = 16,
                    search_radius: int = 16,
                    dtype: torch.dtype = torch.float32,
                    integer_offsets: bool = False, bilinear: bool = False,
                    u8_exact: bool = False,
                    valid_w: int | None = None) -> torch.Tensor:
    """The blend's operands, f32 [2C + 2, H, W]: prev warped by
    ``-factor * mv`` and curr by ``(1 - factor) * mv`` (C planes each,
    unmasked), then each side's OOB mask.  ``valid_w``: the frame's width
    before tpufg's column pad (the masks' right edge; default W)."""
    _, h, w = prev.shape
    g, r = int(block), int(search_radius)
    t, one_t = _blend_weights(factor)
    md = torch.clamp(mv.to(F32), -r, r)
    int_domain = bool(u8_exact) and integer_offsets
    offs = obmc_offsets(mv, r, (-t, one_t), w) if bilinear else None
    planes, masks = [], []
    for x, scale, o in ((prev, -t, None if offs is None else offs[:2]),
                        (curr, one_t, None if offs is None else offs[2:])):
        planes.append(_move(x, md, scale, g, dtype, integer_offsets,
                            int_domain, o))
        masks.append(_oob_mask(md, scale, g, h, w,
                               w if valid_w is None else valid_w, o))
    return torch.cat(planes + masks)


def _channel_mean(x: torch.Tensor) -> torch.Tensor:
    """[C, ...] -> [...]: the channels added in turn, times fl(1/C) (XLA
    compiles the mean's division into that multiply)."""
    s = x[0]
    for c in range(1, x.shape[0]):
        s = s + x[c]
    return s * float(np.float32(1.0) / np.float32(x.shape[0]))


def _cell_means(x: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H/8, W/8] 8x8 cell means: each row's 8 values left to
    right, the 8 row sums top to bottom, times 1/64."""
    h, w = x.shape
    c = x.reshape(h // FB_CELL, FB_CELL, w // FB_CELL, FB_CELL)
    rows = c[..., 0]
    for k in range(1, FB_CELL):
        rows = rows + c[..., k]
    s = rows[:, 0]
    for k in range(1, FB_CELL):
        s = s + rows[:, k]
    return s * (1.0 / (FB_CELL * FB_CELL))


def _fallback_terms(pair: torch.Tensor, prev: torch.Tensor,
                    curr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per pixel [H, W]: the masked warped pair's and the unmoved pair's
    mean absolute disagreement over the RGB channels (d_mc, d_cf)."""
    n_ch = prev.shape[0]
    nc = min(3, n_ch)
    wp, wc = pair[:nc], pair[n_ch:n_ch + nc]
    mp, mc = pair[2 * n_ch], pair[2 * n_ch + 1]
    d_mc = _channel_mean(torch.abs(wp * mp - wc * mc))
    d_cf = _channel_mean(torch.abs(prev[:nc].to(F32) - curr[:nc].to(F32)))
    return d_mc, d_cf


def fallback_cells_plain(pair: torch.Tensor, prev: torch.Tensor,
                         curr: torch.Tensor) -> torch.Tensor:
    """The MC fallback's cell means, f32 [2, H/8, W/8]: d_mc, d_cf."""
    return torch.stack([_cell_means(d) for d in
                        _fallback_terms(pair, prev, curr)])


def warp_epilogue_plain(pair: torch.Tensor, prev: torch.Tensor,
                        curr: torch.Tensor, factor: float = 0.5,
                        occlusion: bool = False, mc_fallback: bool = False,
                        crop: tuple[int, int] | None = None,
                        cells: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of :func:`warp_epilogue`."""
    n_ch, h, w = prev.shape
    t, one_t = _blend_weights(factor)
    wp, wc = pair[:n_ch], pair[n_ch:2 * n_ch]
    mp, mc = pair[2 * n_ch:2 * n_ch + 1], pair[2 * n_ch + 1:]
    out = wp * mp * one_t + wc * mc * t
    if occlusion:
        # photometric disagreement of the two warped sources: large where
        # content is covered or revealed, and averaging would double-expose
        d = _channel_mean(torch.abs(wp - wc))
        k = torch.clamp((d - OCC_D0) * OCC_SLOPE, 0.0, 1.0)
        chosen = wp * mp if float(factor) <= 0.5 else wc * mc
        out = out * (1.0 - k) + chosen * k
    if mc_fallback:
        if h % FB_CELL == 0 and w % FB_CELL == 0:
            if cells is None:
                cells = fallback_cells_plain(pair, prev, curr)
            d_mc = resize_linear(cells[0], (h, w))
            d_cf = resize_linear(cells[1], (h, w))
        else:
            d_mc, d_cf = _fallback_terms(pair, prev, curr)
        rel = d_mc / (d_cf + FB_FLOOR)
        wfb = torch.clamp((rel - FB_LO) / (FB_HI - FB_LO), 0.0, 1.0)
        crossfade = prev.to(F32) * one_t + curr.to(F32) * t
        out = out * (1.0 - wfb) + crossfade * wfb
    if crop is not None and tuple(crop) != (h, w):
        out = out[:, :crop[0], :crop[1]].contiguous()
    return out


def warp_blend_matmul_plain(prev: torch.Tensor, curr: torch.Tensor,
                            mv: torch.Tensor, factor: float = 0.5,
                            block: int = 16, search_radius: int = 16,
                            single: bool = False,
                            dtype: torch.dtype = torch.float32,
                            occlusion: bool = False,
                            integer_offsets: bool = False,
                            bilinear: bool = False, u8_exact: bool = False,
                            mc_fallback: bool = False,
                            crop: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """Plain torch version of :func:`warp_blend_matmul`: it warps the
    whole frame (padded where tpufg's pad reaches the result), then cuts
    ``crop`` out of it."""
    out_h, out_w = _check_options(prev, mv, factor, block, search_radius,
                                  single, dtype, integer_offsets, bilinear,
                                  mc_fallback, crop)
    _, h, w = prev.shape
    g, r = int(block), int(search_radius)
    pw = _col_pad(w, bilinear, mc_fallback and not single)
    if pw:
        prev, curr, mv = _pad_columns(prev, curr, mv, pw, g)
    if single:
        offs = obmc_offsets(mv, r, (1.0,), w + pw) if bilinear else None
        out = _move(prev, torch.clamp(mv.to(F32), -r, r), 1.0, g, dtype,
                    integer_offsets, bool(u8_exact) and integer_offsets,
                    offs)
    else:
        pair = warp_pair_plain(prev, curr, mv, factor, g, r, dtype,
                               integer_offsets, bilinear, u8_exact, w)
        out = warp_epilogue_plain(pair, prev, curr, factor, occlusion,
                                  mc_fallback)
    if (out_h, out_w) == tuple(out.shape[1:]):
        return out
    return out[:, :out_h, :out_w].contiguous()


def _to_kernel(name: str, *tensors: torch.Tensor):
    """f32 contiguous operands on the first one's CUDA device, checked."""
    out = [x.to(F32).contiguous() for x in tensors]
    for i, x in enumerate(out):
        if x.device != out[0].device:
            raise ValueError(f"{name}: operand {i} on {x.device}, the first "
                             f"on {out[0].device}")
        check_kernel_input(x, f"{name} operand {i}", F32, 3)
    return out


def _launch_block(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
                  out: torch.Tensor, block: int, search_radius: int,
                  factor: float, single: bool, integer_offsets: bool,
                  u8_exact: bool, dtype: torch.dtype, pair: bool,
                  valid_w: int | None = None) -> None:
    """One launch of csrc/warp_matmul.cu into ``out``: single or blend
    ([C, out_h, out_w]), or with ``pair`` the warped pair and masks
    ([2C + 2, H, W]); ``valid_w`` the masks' right edge (default W)."""
    n_ch, h, w = prev.shape
    t, one_t = _blend_weights(factor)
    out_h, out_w = (h, w) if pair else tuple(out.shape[1:])
    launch("tpufg_warp_matmul", prev, prev.data_ptr(), curr.data_ptr(),
           mv.data_ptr(), out.data_ptr(), n_ch, h, w, int(block),
           float(int(search_radius)), t, one_t, out_h, out_w,
           int(bool(single)), int(bool(integer_offsets)),
           int(bool(u8_exact) and bool(integer_offsets)),
           int(dtype == torch.bfloat16), int(bool(pair)),
           w if valid_w is None else int(valid_w), out=(out,))
    warp_blend_matmul.launches += 1


def warp_blend_matmul(prev: torch.Tensor, curr: torch.Tensor,
                      mv: torch.Tensor, factor: float = 0.5, block: int = 16,
                      search_radius: int = 16, single: bool = False,
                      dtype: torch.dtype = torch.float32,
                      occlusion: bool = False, integer_offsets: bool = False,
                      bilinear: bool = False, u8_exact: bool = False,
                      mc_fallback: bool = False,
                      crop: tuple[int, int] | None = None) -> torch.Tensor:
    """Motion-compensated warp (``single``) or blend of planar f32
    [C, H, W] frames by [2, H/block, W/block] pixel-unit forward-flow MVs.

    Single mode returns ``prev`` displaced by ``mv``.  Blend mode warps
    prev by ``-factor * mv`` and curr by ``(1 - factor) * mv`` and returns
    ``wp*mask_p*(1-t) + wc*mask_c*t`` with OOB masks, then the
    ``occlusion`` and ``mc_fallback`` blends where asked.  MVs are clipped
    to ``±search_radius``.  ``dtype`` is the value type the pixels move in
    (bf16 or f32), as in tpufg.  ``integer_offsets``: caller-guaranteed
    whole-pixel offsets (one tap, no lerp); otherwise the fractional lerp
    runs; ``bilinear``: the per-pixel (OBMC) warp.  ``crop=(h, w)``
    returns the top-left [C, h, w] window only (the kernels write just
    that window).  CUDA tensors run csrc/warp_matmul.cu (block MVs; one
    launch, counted here), :func:`warp_obmc` (``bilinear``) and
    :func:`warp_epilogue` (the blend options); CPU tensors take
    :func:`warp_blend_matmul_plain`.
    """
    if prev.dim() != 3 or prev.shape != curr.shape:
        raise ValueError(f"prev/curr must be one [C, H, W] shape, got "
                         f"{tuple(prev.shape)} and {tuple(curr.shape)}")
    out_h, out_w = _check_options(prev, mv, factor, block, search_radius,
                                  single, dtype, integer_offsets, bilinear,
                                  mc_fallback, crop)
    if use_plain(prev):
        return warp_blend_matmul_plain(prev, curr, mv, factor, block,
                                       search_radius, single, dtype,
                                       occlusion, integer_offsets, bilinear,
                                       u8_exact, mc_fallback, crop)
    prev, curr, mv = _to_kernel("warp_blend_matmul", prev, curr, mv)
    n_ch, _, w = prev.shape
    g, r = int(block), int(search_radius)
    options = (occlusion or mc_fallback) and not single
    pw = _col_pad(w, bilinear, mc_fallback and not single)
    if pw:
        prev, curr, mv = _pad_columns(prev, curr, mv, pw, g)
    if bilinear and not options:
        return warp_obmc(prev, curr, mv, factor, g, r, single, dtype,
                         valid_w=w, crop=(out_h, out_w))
    if options:
        cells = None
        if bilinear:
            # the fallback's cell means made by the warp, in its launch
            pair = warp_obmc(prev, curr, mv, factor, g, r, dtype=dtype,
                             pair=True, valid_w=w, cells=mc_fallback)
            if mc_fallback:
                pair, cells = pair
        else:
            pair = torch.empty((2 * n_ch + 2,) + tuple(prev.shape[1:]),
                               dtype=F32, device=prev.device)
            _launch_block(prev, curr, mv, pair, g, r, factor, False,
                          integer_offsets, u8_exact, dtype, True, w)
        return warp_epilogue(pair, prev, curr, factor, occlusion,
                             mc_fallback, crop=(out_h, out_w), cells=cells)
    out = torch.empty((n_ch, out_h, out_w), dtype=F32, device=prev.device)
    _launch_block(prev, curr, mv, out, g, r, factor, single, integer_offsets,
                  u8_exact, dtype, False)
    return out


warp_blend_matmul.launches = 0


def warp_obmc_plain(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
                    factor: float = 0.5, block: int = 8,
                    search_radius: int = 16, single: bool = False,
                    dtype: torch.dtype = torch.float32, pair: bool = False,
                    valid_w: int | None = None,
                    crop: tuple[int, int] | None = None, cells: bool = False):
    """Plain torch version of :func:`warp_obmc`."""
    _check_options(prev, mv, factor, block, search_radius, single, dtype,
                   False, True, False, crop)
    _, _, w = prev.shape
    g, r = int(block), int(search_radius)
    if single:
        out = _move(prev, None, 1.0, g, dtype, False, False,
                    obmc_offsets(mv, r, (1.0,), w))
    else:
        out = warp_pair_plain(prev, curr, mv, factor, g, r, dtype,
                              bilinear=True, valid_w=valid_w)
        if pair:
            return (out, fallback_cells_plain(out, prev, curr)) if cells \
                else out
        out = warp_epilogue_plain(out, prev, curr, factor)
    if crop is None or tuple(crop) == tuple(out.shape[1:]):
        return out
    return out[:, :crop[0], :crop[1]].contiguous()


def warp_obmc(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
              factor: float = 0.5, block: int = 8, search_radius: int = 16,
              single: bool = False, dtype: torch.dtype = torch.float32,
              pair: bool = False, valid_w: int | None = None,
              crop: tuple[int, int] | None = None, cells: bool = False):
    """The per-pixel (OBMC) warp of ``warp_blend_matmul(bilinear=True)``
    on frames taken as given (no column pad): single mode, the blend
    (cropped to ``crop``), or with ``pair`` (blend mode) the warped pair
    and masks [2C + 2, H, W] for :func:`warp_epilogue`; with ``pair`` and
    ``cells`` also the MC fallback's cell means ([2, H/8, W/8],
    :func:`fallback_cells_plain` of that pair), returned as (pair, cells)
    and made in the same launch.  ``valid_w``: the masks' right edge (the
    width before a column pad; default W).  CUDA tensors run
    csrc/warp_obmc.cu, one launch that makes the per-column offsets
    (:func:`obmc_offsets`) from the MV lattice itself; the wrapper hands it
    ``jax.image.resize``'s column and row taps (made once per size) and
    runs no torch op but the outputs' allocation.  CPU tensors take
    :func:`warp_obmc_plain`."""
    out_h, out_w = _check_options(prev, mv, factor, block, search_radius,
                                  single, dtype, False, True, False, crop)
    if use_plain(prev):
        return warp_obmc_plain(prev, curr, mv, factor, block, search_radius,
                               single, dtype, pair, valid_w, crop, cells)
    prev, curr, mv = _to_kernel("warp_obmc", prev, curr, mv)
    n_ch, h, w = prev.shape
    g, r = int(block), int(search_radius)
    t, one_t = _blend_weights(factor)
    tx = linear_taps(w // g, w, prev.device)
    ty = linear_taps(h // g, h, prev.device)
    pair = pair and not single
    if pair:
        shape, out_h, out_w, mode = (2 * n_ch + 2, h, w), h, w, 2 + cells
    else:
        shape, mode = (n_ch, out_h, out_w), 0 if single else 1
    out = torch.empty(shape, dtype=F32, device=prev.device)
    cell_means = (torch.empty((2, h // FB_CELL, w // FB_CELL), dtype=F32,
                              device=prev.device) if mode == 3 else None)
    launch("tpufg_warp_obmc", prev, prev.data_ptr(), curr.data_ptr(),
           mv.data_ptr(), tx.i0_i32.data_ptr(), tx.w0.data_ptr(),
           tx.w1.data_ptr(), ty.i0_i32.data_ptr(), ty.w0.data_ptr(),
           ty.w1.data_ptr(), out.data_ptr(),
           0 if cell_means is None else cell_means.data_ptr(), n_ch, h, w, g,
           w if valid_w is None else int(valid_w), float(r), t, one_t, out_h,
           out_w, mode, int(dtype == torch.bfloat16),
           out=(out,) if cell_means is None else (out, cell_means))
    warp_obmc.launches += 1
    return out if cell_means is None else (out, cell_means)


warp_obmc.launches = 0


def warp_epilogue(pair: torch.Tensor, prev: torch.Tensor, curr: torch.Tensor,
                  factor: float = 0.5, occlusion: bool = False,
                  mc_fallback: bool = False,
                  crop: tuple[int, int] | None = None,
                  cells: torch.Tensor | None = None) -> torch.Tensor:
    """The blend of a warped pair (``pair``: [2C + 2, H, W] f32, the
    warped prev and curr unmasked, then their masks) of planar prev and
    curr [C, H, W]: ``wp * mask_p * (1 - t) + wc * mask_c * t``, then the
    occlusion blend and the MC fallback where asked; f32 [C, H, W] or the
    top-left ``crop``.  ``cells``: the fallback's cell means of this pair
    where already made (``warp_obmc(..., cells=True)``).  CUDA tensors run
    csrc/warp_epilogue.cu (with the fallback by cells and no ``cells``
    one launch for the cell means, then one for the blend, each counted),
    CPU tensors :func:`warp_epilogue_plain`."""
    n_ch, h, w = prev.shape
    if tuple(pair.shape) != (2 * n_ch + 2, h, w) or curr.shape != prev.shape:
        raise ValueError(f"pair {tuple(pair.shape)}, curr "
                         f"{tuple(curr.shape)} for prev {tuple(prev.shape)}")
    out_h, out_w = (h, w) if crop is None else (int(crop[0]), int(crop[1]))
    if not (0 < out_h <= h and 0 < out_w <= w):
        raise ValueError(f"crop {crop} outside the {h}x{w} frame")
    cells_ok = mc_fallback and h % FB_CELL == 0 and w % FB_CELL == 0
    if cells is not None and (not cells_ok or tuple(cells.shape) != (
            2, h // FB_CELL, w // FB_CELL)):
        raise ValueError(f"cells {tuple(cells.shape)} for a {h}x{w} fallback "
                         f"by cells ({cells_ok})")
    if use_plain(pair):
        return warp_epilogue_plain(pair, prev, curr, factor, occlusion,
                                   mc_fallback, crop, cells)
    pair, prev, curr = _to_kernel("warp_epilogue", pair, prev, curr)
    t, one_t = _blend_weights(factor)
    dev = prev.device
    if cells is not None:
        cells = _to_kernel("warp_epilogue", pair, cells)[1]
    elif cells_ok:
        cells = torch.empty((2, h // FB_CELL, w // FB_CELL), dtype=F32,
                            device=dev)
        launch("tpufg_warp_fallback_cells", prev, pair.data_ptr(),
               prev.data_ptr(), curr.data_ptr(), cells.data_ptr(), n_ch, h,
               w, out=(cells,))
        warp_epilogue.launches += 1
    if cells_ok:
        ty = linear_taps(h // FB_CELL, h, dev)
        tx = linear_taps(w // FB_CELL, w, dev)
    else:
        cells = pair        # unread
        ty = tx = linear_taps(1, 1, dev)
    out = torch.empty((n_ch, out_h, out_w), dtype=F32, device=dev)
    # fallback: 0 off, 1 per pixel, 2 by cells
    launch("tpufg_warp_epilogue", prev, pair.data_ptr(), prev.data_ptr(),
           curr.data_ptr(), cells.data_ptr(), ty.i0_i32.data_ptr(),
           ty.w0.data_ptr(), ty.w1.data_ptr(), tx.i0_i32.data_ptr(),
           tx.w0.data_ptr(), tx.w1.data_ptr(), out.data_ptr(), n_ch, h, w,
           t, one_t, out_h, out_w, int(bool(occlusion)),
           int(bool(mc_fallback)) + int(cells_ok),
           int(float(factor) <= 0.5), out=(out,))
    warp_epilogue.launches += 1
    return out


warp_epilogue.launches = 0
