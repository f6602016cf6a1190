"""The exact precision path's two kernels: the shader's Lanczos scale with
its UNORM8 store, and its motion-compensated warp.

tpufg's exact path is the XLA ops of ``tpufg/ops/oracle.py`` and reaches
no Pallas kernel; the port runs two of those ops on hand-written CUDA
kernels, each bitwise to its plain version, which composes the functions
of ``tpufg_torch/ops/oracle.py``:

- :func:`oracle_scale` (csrc/oracle_scale.cu): ``lanczos_scale`` then
  ``quantize_unorm8``, f32 RGBA [H, W, 4] -> uint8 RGBA [oh, ow, 4];
- :func:`oracle_warp` (csrc/oracle_warp.cu): ``warp_blend`` with a
  per-pixel MV field or none (a crossfade), f32 RGBA [H, W, 4] -> the same.

Both kernels take their tap and pixel-centre tables from the torch ops the
plain versions use (``axis_tables``, ``warp_tables``, made once per shape)
and round every operation as those do (csrc/oracle_round.cuh).  The exact
step's third kernel is the per-pixel search with the exact box
(``kernels/motion.py::motion_search_tiled``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each counts its launches in ``launches``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain
from tpufg_torch.ops import oracle

F32 = torch.float32


def oracle_scale_plain(img: torch.Tensor, out_h: int, out_w: int,
                       a: int = 3) -> torch.Tensor:
    """Plain version of :func:`oracle_scale`: the oracle's Lanczos resample
    and UNORM8 store."""
    return oracle.quantize_unorm8(oracle.lanczos_scale(img, out_h, out_w, a))


def oracle_warp_plain(prev: torch.Tensor, curr: torch.Tensor,
                      motion: Optional[torch.Tensor],
                      factor: float) -> torch.Tensor:
    """Plain version of :func:`oracle_warp`: the oracle's warp and blend."""
    return oracle.warp_blend(prev, curr, motion, factor)


@functools.lru_cache(maxsize=32)
def _scale_tables(in_size: int, out_size: int, a: int,
                  device: torch.device) -> tuple:
    """One axis's tap tables in the kernel's types: (index i32, weight
    f32, valid u8), each [out, 2a]."""
    idx, w, valid = oracle.axis_tables(in_size, out_size, a, device)
    return (idx.to(torch.int32).contiguous(), w.contiguous(),
            valid.to(torch.uint8).contiguous())


def _check_rgba(x: torch.Tensor, name: str) -> None:
    check_kernel_input(x, name, F32, 3)
    if x.shape[-1] != 4:
        raise ValueError(f"{name}: expected RGBA [H, W, 4], got "
                         f"{tuple(x.shape)}")


def oracle_scale(img: torch.Tensor, out_h: int, out_w: int,
                 a: int = 3) -> torch.Tensor:
    """Lanczos-a resample and UNORM8 store of f32 RGBA [H, W, 4] ->
    uint8 [out_h, out_w, 4], as ``quantize_unorm8(lanczos_scale(...))`` of
    the oracle.  CUDA tensors run csrc/oracle_scale.cu (4 channels); CPU
    tensors take :func:`oracle_scale_plain`."""
    if use_plain(img):
        return oracle_scale_plain(img, out_h, out_w, a)
    _check_rgba(img, "oracle_scale")
    in_h, in_w, _ = img.shape
    iy, wy, vy = _scale_tables(in_h, out_h, a, img.device)
    ix, wx, vx = _scale_tables(in_w, out_w, a, img.device)
    out = torch.empty((out_h, out_w, 4), dtype=torch.uint8,
                      device=img.device)
    launch("tpufg_oracle_scale", img, img.data_ptr(), iy.data_ptr(),
           wy.data_ptr(), vy.data_ptr(), ix.data_ptr(), wx.data_ptr(),
           vx.data_ptr(), out.data_ptr(), in_h, in_w, out_h, out_w, 2 * a,
           out=(out,))
    oracle_scale.launches += 1
    return out


def oracle_warp(prev: torch.Tensor, curr: torch.Tensor,
                motion: Optional[torch.Tensor],
                factor: float) -> torch.Tensor:
    """The oracle's warp and blend of f32 RGBA [H, W, 4] frames with a
    per-pixel MV field f32 [H, W, 2] in pixels, or None (a crossfade), at
    blend factor ``factor`` -> f32 [H, W, 4].  CUDA tensors run
    csrc/oracle_warp.cu (a coarser MV grid is refused there: the exact
    path never makes one); CPU tensors take :func:`oracle_warp_plain`."""
    if use_plain(prev):
        return oracle_warp_plain(prev, curr, motion, factor)
    _check_rgba(prev, "oracle_warp")
    _check_rgba(curr, "oracle_warp")
    h, w, _ = prev.shape
    if curr.shape != prev.shape or curr.device != prev.device:
        raise ValueError(f"oracle_warp: prev {tuple(prev.shape)} on "
                         f"{prev.device}, curr {tuple(curr.shape)} on "
                         f"{curr.device}")
    if motion is not None:
        check_kernel_input(motion, "oracle_warp", F32, 3)
        if tuple(motion.shape) != (h, w, 2) or motion.device != prev.device:
            raise ValueError(f"oracle_warp: the kernel takes a per-pixel MV "
                             f"field [{h}, {w}, 2] on {prev.device}, got "
                             f"{tuple(motion.shape)} on {motion.device}")
    tb = oracle.warp_tables(h, w, float(factor), prev.device)
    out = torch.empty_like(prev)
    launch("tpufg_oracle_warp", prev, prev.data_ptr(), curr.data_ptr(),
           None if motion is None else motion.data_ptr(),
           tb.u.data_ptr(), tb.v.data_ptr(), tb.x.data_ptr(),
           tb.y.data_ptr(), out.data_ptr(), h, w, tb.t, tb.omt,
           *tb.kx, *tb.ky, int(tb.fuse_x), int(tb.fuse_y),
           out=(out,))
    oracle_warp.launches += 1
    return out


oracle_scale.launches = 0
oracle_warp.launches = 0
