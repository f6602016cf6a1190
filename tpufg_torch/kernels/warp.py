"""Block-granular motion-compensated warp and blend.

Counterpart of ``tpufg/kernels/warp.py`` (``warp_blend_block``, the Pallas
kernel of ``interpolate.comp``).  The MV field holds one pixel-unit
forward-flow vector per ``block`` x ``block`` tile.  Per output pixel p,
with m its block's MV clipped to +-``search_radius`` and t = ``factor``:

- blend: prev sampled at p + m*(-t), curr at p + m*(1-t), each bilinear
  with edge-clamped taps, each blanked (transparent black) where its
  sample point leaves [-0.5, size - 0.5], then ``p*pmask*(1-t) +
  c*cmask*t``;
- ``single``: prev sampled at p + m, no mask (no centring round trip,
  unlike ``warp_blend_matmul``'s single mode).

tpufg samples from an edge-padded halo of ``round_up(r+2, 8)`` around
aligned tiles, which is exactly an edge clamp since offsets never pass
+-r; its tiling knobs (``tile_h``, ``tile_w``, ``interpret``) are not
taken.  The plain version below computes in f32 with one rounding per
operation, in tpufg's source order; the CUDA kernel (csrc/warp_block.cu)
follows it with ``_rn`` intrinsics and is bitwise equal to it.  On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain

F32 = torch.float32


def _check(prev: torch.Tensor, curr: torch.Tensor, mv: torch.Tensor,
           g: int) -> None:
    if prev.dim() != 3 or prev.shape != curr.shape:
        raise ValueError(f"prev/curr must be one [C, H, W] shape, got "
                         f"{tuple(prev.shape)} and {tuple(curr.shape)}")
    _, h, w = prev.shape
    if g <= 0 or h % g or w % g:
        raise ValueError(f"frame {h}x{w} not a multiple of block {g}")
    if tuple(mv.shape) != (2, h // g, w // g):
        raise ValueError(f"mv must be [2, {h // g}, {w // g}], got "
                         f"{tuple(mv.shape)}")


def _blend_weights(factor: float) -> tuple[float, float]:
    """(t, 1 - t) as f32 values, 1 - t rounded once in f32 as tpufg's
    ``F32(1.0) - tf`` (Python floats: no host-to-device copy)."""
    t = np.float32(factor)
    return float(t), float(np.float32(1.0) - t)


def warp_blend_block_plain(prev: torch.Tensor, curr: torch.Tensor,
                           mv: torch.Tensor, factor: float = 0.5,
                           block: int = 16, search_radius: int = 16,
                           single: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`warp_blend_block`."""
    g = int(block)
    _check(prev, curr, mv, g)
    _, h, w = prev.shape
    dev = prev.device
    prev, curr = prev.to(F32), curr.to(F32)
    r = float(search_radius)
    md = torch.clamp(mv.to(F32), -r, r)            # [2, H/g, W/g]
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]

    def per_pixel(v):                              # [H/g, W/g] -> [H, W]
        return v.repeat_interleave(g, 0).repeat_interleave(g, 1)

    def sample(src, ox, oy):
        fl_x, fl_y = torch.floor(ox), torch.floor(oy)
        fx, fy = per_pixel(ox - fl_x), per_pixel(oy - fl_y)
        x0 = cols + per_pixel(fl_x).long()
        y0 = rows + per_pixel(fl_y).long()
        xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
        ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
        gx, gy = 1.0 - fx, 1.0 - fy
        top = src[:, ya, xa] * gx + src[:, ya, xb] * fx
        bot = src[:, yb, xa] * gx + src[:, yb, xb] * fx
        return top * gy + bot * fy

    if single:
        return sample(prev, md[0], md[1])

    def mask(ox, oy):
        px = cols.to(F32) + per_pixel(ox)
        py = rows.to(F32) + per_pixel(oy)
        return ((px >= -0.5) & (px <= w - 0.5)
                & (py >= -0.5) & (py <= h - 0.5)).to(F32)

    t, omt = _blend_weights(factor)
    pox, poy = md[0] * (-t), md[1] * (-t)
    cox, coy = md[0] * omt, md[1] * omt
    p = sample(prev, pox, poy)
    c = sample(curr, cox, coy)
    return p * mask(pox, poy) * omt + c * mask(cox, coy) * t


def warp_blend_block(prev: torch.Tensor, curr: torch.Tensor,
                     mv: torch.Tensor, factor: float = 0.5, block: int = 16,
                     search_radius: int = 16,
                     single: bool = False) -> torch.Tensor:
    """Block-granular motion-compensated blend.

    ``prev``/``curr``: planar [C, H, W], read as f32; ``mv``: [2, H/block,
    W/block] pixel-unit forward-flow MVs (plane 0 = dx, 1 = dy).  Returns
    f32 [C, H, W].  H and W must be multiples of ``block``.  CUDA tensors
    run csrc/warp_block.cu; CPU tensors take :func:`warp_blend_block_plain`.
    """
    if use_plain(prev):
        return warp_blend_block_plain(prev, curr, mv, factor, block,
                                      search_radius, single)
    g = int(block)
    _check(prev, curr, mv, g)
    prev, curr = prev.to(F32).contiguous(), curr.to(F32).contiguous()
    mv = mv.to(F32).contiguous()
    for name, x in (("prev", prev), ("curr", curr), ("mv", mv)):
        if x.device != prev.device:
            raise ValueError(f"warp_blend_block: {name} on {x.device}, prev "
                             f"on {prev.device}")
        check_kernel_input(x, f"warp_blend_block {name}", F32, 3)
    n_ch, h, w = prev.shape
    t, _ = _blend_weights(factor)
    out = torch.empty_like(prev)
    launch("tpufg_warp_block", prev, prev.data_ptr(), curr.data_ptr(),
           mv.data_ptr(), out.data_ptr(), n_ch, h, w, g,
           float(search_radius), t, int(bool(single)), out=(out,))
    warp_blend_block.launches += 1
    return out


warp_blend_block.launches = 0
