"""Block-granular warp and blend (plain torch gathers).

Counterpart of ``tpufg/kernels/warp_matmul.py::warp_blend_matmul`` without
the bilinear MV field, the occlusion blend and the MC fallback.  The TPU
moves pixels with one-hot shift matmuls; here a gather reads the same
taps.  Two kinds of per-block offset:

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

Taps clamp to the frame's edge, and a sample whose displaced position
falls outside ``[-0.5, W - 0.5] x [-0.5, H - 0.5]`` is blanked in the
blend (interpolate.comp's uv-outside-[0,1] rule).  W and H are those of
the frame given here — in the engine, the 64-lattice-padded frame.  tpufg
edge-pads W to a multiple of 128 for its matmuls; single mode has no
blanking, so the clamped gather needs no such pad.  Any block size that
divides H and W runs (the learned head's coarse warp uses 8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpufg_torch.kernels.common import round_up
from tpufg_torch.kernels.convert import INV255


def _check_reach(eff_r: int, g: int) -> None:
    """tpufg's limit on the per-frame reach ``eff_r``: its band halo must
    fit the warp's 256-column window."""
    halo = round_up(eff_r + 2, 8)
    while (2 * halo) % g:
        halo += 8
    if halo > 63:
        raise ValueError("search radius too large for the 256-col window")


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
    f32 = torch.float32
    return (a.to(f32) * (1.0 - f).to(f32) + b.to(f32) * f.to(f32)).to(dtype)


def warp_blend_matmul(prev: torch.Tensor, curr: torch.Tensor,
                      mv: torch.Tensor, factor: float = 0.5, block: int = 16,
                      search_radius: int = 16, single: bool = False,
                      dtype: torch.dtype = torch.float32,
                      occlusion: bool = False, integer_offsets: bool = False,
                      bilinear: bool = False, u8_exact: bool = False,
                      mc_fallback: bool = False) -> torch.Tensor:
    """Motion-compensated warp (``single``) or blend of planar f32
    [C, H, W] frames by [2, H/block, W/block] pixel-unit forward-flow MVs.

    Single mode returns ``prev`` displaced by ``mv``.  Blend mode warps
    prev by ``-factor * mv`` and curr by ``(1 - factor) * mv`` and returns
    ``wp*mask_p*(1-t) + wc*mask_c*t`` with OOB masks.  MVs are clipped to
    ``±search_radius``.  ``dtype`` is the value type the pixels move in
    (bf16 or f32), as in tpufg.  ``integer_offsets``: caller-guaranteed
    whole-pixel offsets (one gather, no lerp); otherwise the fractional
    lerp runs.
    """
    if bilinear:
        raise NotImplementedError(
            "warp_blend_matmul: bilinear (--mv-grid 8/1) is not yet ported")
    if occlusion:
        raise NotImplementedError(
            "warp_blend_matmul: --occlusion-blend is not yet ported")
    if mc_fallback:
        raise NotImplementedError(
            "warp_blend_matmul: --mc-fallback is not yet ported")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"warp dtype must be f32 or bf16, got {dtype}")
    n_ch, h, w = prev.shape
    g, r = int(block), int(search_radius)
    if h % g or w % g:
        raise ValueError(f"frame {h}x{w}: H%{g} and W%{g} must be 0")
    n_by, n_bx = h // g, w // g
    if tuple(mv.shape) != (2, n_by, n_bx):
        raise ValueError(f"mv shape {tuple(mv.shape)} != (2, {n_by}, {n_bx})")
    eff_r = r if single else max(1, int(math.ceil(
        r * max(float(factor), 1.0 - float(factor)))))
    _check_reach(eff_r, g)
    dev = prev.device
    f32 = torch.float32
    # the f32 blend weights t and 1 - t as Python floats: a CUDA scalar
    # tensor made from the host would synchronise the stream
    t = float(np.float32(factor))
    one_t = float(np.float32(1.0) - np.float32(factor))
    mdx = torch.clamp(mv[0].to(f32), -r, r)
    mdy = torch.clamp(mv[1].to(f32), -r, r)
    # as in tpufg: the integer-code domain only for whole-pixel moves
    int_domain = bool(u8_exact) and integer_offsets
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]

    def move(x: torch.Tensor, scale: float) -> torch.Tensor:
        # into the domain the TPU moves values in, gather, and back
        x = x.to(f32)
        if int_domain:
            v = torch.round(x * 255.0) - 128.0
        else:
            v = x - 0.5
        v = v.to(dtype)
        oy = _block_offsets(mdy, scale, g)
        ox = _block_offsets(mdx, scale, g)
        fy, fx = torch.floor(oy), torch.floor(ox)
        rows = ys + fy.to(torch.int64)
        cols = xs + fx.to(torch.int64)
        if integer_offsets:
            o = _gather(v, rows, cols)
        else:
            wy, wx = (oy - fy).to(dtype), (ox - fx).to(dtype)

            def row_lerp(at: torch.Tensor) -> torch.Tensor:
                return _hlerp(_gather(v, at, cols), _gather(v, at, cols + 1),
                              wx, dtype)

            # the vertical lerp is elementwise in ``dtype`` in tpufg: each
            # product and the sum round to ``dtype``
            o = row_lerp(rows) * (1.0 - wy) + row_lerp(rows + 1) * wy
        o = o.to(f32)
        if int_domain:
            return (o + 128.0) * INV255
        return o + 0.5

    def oob_mask(scale: float) -> torch.Tensor:
        px = xs.to(f32) + _block_offsets(mdx, scale, g)
        py = ys.to(f32) + _block_offsets(mdy, scale, g)
        ok = (px >= -0.5) & (px <= w - 0.5) & (py >= -0.5) & (py <= h - 0.5)
        return ok.to(f32)[None]

    if single:
        return move(prev, 1.0)
    warped_p = move(prev, -t)
    warped_c = move(curr, one_t)
    return (warped_p * oob_mask(-t) * one_t
            + warped_c * oob_mask(one_t) * t)
