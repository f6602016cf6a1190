"""Block-granular integer-offset warp and blend (plain torch gather).

Counterpart of ``tpufg/kernels/warp_matmul.py::warp_blend_matmul``,
restricted to the main path: ``integer_offsets=True`` (each 16-px block
moves by a whole number of pixels), no bilinear MV field, no occlusion
blend, no MC fallback.  The TPU needs one-hot shift matmuls to move
pixels; with one-hot weights of exactly 0 and 1 those products select a
single value, so a gather reproduces them bit for bit, provided the value
domain around the move is reproduced too:

- single mode (the pyramid's refine warp) moves centred values and
  un-centres them: ``fl(fl(x - 0.5) + 0.5)``, which is not always ``x``;
- with ``u8_exact`` (the engine's blend) values move as centred integer
  codes ``round(255 x) - 128`` and come back as ``(o + 128) * fl(1/255)``
  (tpufg writes ``/ 255``, which XLA compiles into that multiply; see
  ``kernels/convert.py``).

Taps clamp to the frame's edge, and a sample whose displaced position
falls outside ``[-0.5, W - 0.5] x [-0.5, H - 0.5]`` is blanked in the
blend (interpolate.comp's uv-outside-[0,1] rule).  W and H are those of
the frame given here — in the engine, the 64-lattice-padded frame.
"""

from __future__ import annotations

import math

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


def _block_offsets(md: torch.Tensor, scale: torch.Tensor,
                   g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel float offset and floor-integer offset along one axis:
    block values ``md * scale`` repeated over [n_by*g, n_bx*g] pixels."""
    o = md * scale
    pix = o.repeat_interleave(g, dim=0).repeat_interleave(g, dim=1)
    return pix, torch.floor(pix).to(torch.int64)


def _gather(v: torch.Tensor, iy: torch.Tensor,
            ix: torch.Tensor) -> torch.Tensor:
    """v [C, H, W]; per-pixel integer offsets [H, W] -> v at the clamped
    displaced positions (clamp-to-edge taps)."""
    c, h, w = v.shape
    ys = torch.arange(h, device=v.device)[:, None]
    xs = torch.arange(w, device=v.device)[None, :]
    rows = torch.clamp(ys + iy, 0, h - 1)
    cols = torch.clamp(xs + ix, 0, w - 1)
    flat = (rows * w + cols).reshape(-1)
    return v.reshape(c, h * w)[:, flat].reshape(c, h, w)


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
    (bf16 or f32), as in tpufg.
    """
    if not integer_offsets:
        raise NotImplementedError(
            "warp_blend_matmul: fractional offsets are not yet ported")
    if bilinear:
        raise NotImplementedError(
            "warp_blend_matmul: bilinear (--mv-grid 8/1) is not yet ported")
    if occlusion:
        raise NotImplementedError(
            "warp_blend_matmul: --occlusion-blend is not yet ported")
    if mc_fallback:
        raise NotImplementedError(
            "warp_blend_matmul: --mc-fallback is not yet ported")
    if block != 16:
        raise NotImplementedError(
            f"warp_blend_matmul: block {block} is not yet ported (16 only)")
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
    t = torch.tensor(factor, dtype=f32, device=dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    mdx = torch.clamp(mv[0].to(f32), -r, r)
    mdy = torch.clamp(mv[1].to(f32), -r, r)
    int_domain = bool(u8_exact)

    def move(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        # into the domain the TPU moves values in, gather, and back
        x = x.to(f32)
        if int_domain:
            v = torch.round(x * 255.0) - 128.0
        else:
            v = x - 0.5
        _, iy = _block_offsets(mdy, scale, g)
        _, ix = _block_offsets(mdx, scale, g)
        o = _gather(v.to(dtype), iy, ix).to(f32)
        if int_domain:
            return (o + 128.0) * INV255
        return o + 0.5

    def oob_mask(scale: torch.Tensor) -> torch.Tensor:
        fx, _ = _block_offsets(mdx, scale, g)
        fy, _ = _block_offsets(mdy, scale, g)
        px = torch.arange(w, dtype=f32, device=dev)[None, :] + fx
        py = torch.arange(h, dtype=f32, device=dev)[:, None] + fy
        ok = (px >= -0.5) & (px <= w - 0.5) & (py >= -0.5) & (py <= h - 0.5)
        return ok.to(f32)[None]

    if single:
        return move(prev, one)
    warped_p = move(prev, -t)
    warped_c = move(curr, one - t)
    return (warped_p * oob_mask(-t) * (one - t)
            + warped_c * oob_mask(one - t) * t)
