"""Block-granular warp and blend: a CUDA kernel and its plain version.

Counterpart of ``tpufg/kernels/warp_matmul.py::warp_blend_matmul`` without
the bilinear MV field, the occlusion blend and the MC fallback.  The TPU
moves pixels with one-hot shift matmuls; the plain version here
(:func:`warp_blend_matmul_plain`) gathers the same taps, and the CUDA
kernel csrc/warp_matmul.cu (the tile walk of csrc/warp_tile.cuh, one
launch per warp) computes the same values bitwise.  On a CPU tensor the
wrapper :func:`warp_blend_matmul` runs the plain version; on a CUDA tensor
it launches the kernel or raises.  Two kinds of per-block offset:

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

from tpufg_torch.kernels.common import (check_kernel_input, launch, on_cpu,
                                        round_up)
from tpufg_torch.kernels.convert import INV255

F32 = torch.float32


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


def _check_options(prev: torch.Tensor, mv: torch.Tensor, factor: float,
                   block: int, search_radius: int, single: bool,
                   dtype: torch.dtype, occlusion: bool, bilinear: bool,
                   mc_fallback: bool,
                   crop: tuple[int, int] | None) -> tuple[int, int]:
    """The refusals both forms share: unported options, the moving type,
    the block lattice, the MV shape, tpufg's reach limit and a crop past
    the frame.  Returns the output's (rows, columns)."""
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
    out_h, out_w = (h, w) if crop is None else (int(crop[0]), int(crop[1]))
    if not (0 < out_h <= h and 0 < out_w <= w):
        raise ValueError(f"crop {crop} outside the {h}x{w} frame")
    return out_h, out_w


def _blend_weights(factor: float) -> tuple[float, float]:
    """The f32 blend weights (t, 1 - t) as Python floats (a CUDA scalar
    tensor made from the host would synchronise the stream)."""
    return (float(np.float32(factor)),
            float(np.float32(1.0) - np.float32(factor)))


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
    whole frame, then cuts ``crop`` out of it."""
    out_h, out_w = _check_options(prev, mv, factor, block, search_radius,
                                  single, dtype, occlusion, bilinear,
                                  mc_fallback, crop)
    n_ch, h, w = prev.shape
    g, r = int(block), int(search_radius)
    dev = prev.device
    f32 = torch.float32
    t, one_t = _blend_weights(factor)
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
        out = move(prev, 1.0)
    else:
        out = (move(prev, -t) * oob_mask(-t) * one_t
               + move(curr, one_t) * oob_mask(one_t) * t)
    if crop is None:
        return out
    return out[:, :out_h, :out_w].contiguous()


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
    ``wp*mask_p*(1-t) + wc*mask_c*t`` with OOB masks.  MVs are clipped to
    ``±search_radius``.  ``dtype`` is the value type the pixels move in
    (bf16 or f32), as in tpufg.  ``integer_offsets``: caller-guaranteed
    whole-pixel offsets (one tap, no lerp); otherwise the fractional lerp
    runs.  ``crop=(h, w)`` returns the top-left [C, h, w] window only (the
    kernel writes just that window).  CUDA tensors run csrc/warp_matmul.cu;
    CPU tensors take :func:`warp_blend_matmul_plain`.
    """
    if prev.dim() != 3 or prev.shape != curr.shape:
        raise ValueError(f"prev/curr must be one [C, H, W] shape, got "
                         f"{tuple(prev.shape)} and {tuple(curr.shape)}")
    out_h, out_w = _check_options(prev, mv, factor, block, search_radius,
                                  single, dtype, occlusion, bilinear,
                                  mc_fallback, crop)
    if on_cpu(prev):
        return warp_blend_matmul_plain(prev, curr, mv, factor, block,
                                       search_radius, single, dtype,
                                       occlusion, integer_offsets, bilinear,
                                       u8_exact, mc_fallback, crop)
    n_ch, h, w = prev.shape
    prev, curr = prev.to(F32).contiguous(), curr.to(F32).contiguous()
    mv = mv.to(F32).contiguous()
    for name, x in (("prev", prev), ("curr", curr), ("mv", mv)):
        if x.device != prev.device:
            raise ValueError(f"warp_blend_matmul: {name} on {x.device}, prev "
                             f"on {prev.device}")
        check_kernel_input(x, f"warp_blend_matmul {name}", F32, 3)
    t, one_t = _blend_weights(factor)
    out = torch.empty((n_ch, out_h, out_w), dtype=F32, device=prev.device)
    launch("tpufg_warp_matmul", prev, prev.data_ptr(), curr.data_ptr(),
           mv.data_ptr(), out.data_ptr(), n_ch, h, w, int(block),
           float(int(search_radius)), t, one_t, out_h, out_w,
           int(bool(single)), int(bool(integer_offsets)),
           int(bool(u8_exact) and bool(integer_offsets)),
           int(dtype == torch.bfloat16))
    warp_blend_matmul.launches += 1
    return out


warp_blend_matmul.launches = 0
