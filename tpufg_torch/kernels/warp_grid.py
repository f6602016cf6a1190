"""RIFE's backward warp (``model/warplayer.py``): the grid from the flow
and ``grid_sample`` (bilinear, border, ``align_corners=True``), for the
IFNet (``models/ifnet.py``).

``warp_plain`` is the published warp in plain torch, which CPU tensors
take (``warp_features_into_plain`` writes it into a channel slice).  On the card, :func:`warp_frames` (f32 planar frames) and
:func:`warp_features_into` (channels-last bf16 features, written straight
into a channel slice of a wider channels-last tensor) run the kernel
``csrc/warp_grid.cu``: the grid made with the same roundings (the flow
times the f32 reciprocal of ``(W - 1) / 2``, as PyTorch divides by a
host scalar on the card, then added to the linspace grid) and the sample
in ``grid_sample``'s order, in one pass.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32
BF16 = torch.bfloat16


@functools.lru_cache(maxsize=32)
def _linspace(n: int, device: torch.device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, device=device)


def _base_grid(n: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """warplayer's grid: [n, 2, h, w] of linspace(-1, 1) along x and y."""
    gx = _linspace(w, device).view(1, 1, 1, w).expand(n, 1, h, w)
    gy = _linspace(h, device).view(1, 1, h, 1).expand(n, 1, h, w)
    return torch.cat([gx, gy], 1)


def warp_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of [n, C, h, w] (f32) by the f32 flows [n, 2, h, w]
    (image k by flow k), as warplayer.py computes it."""
    n, _, h, w = flow.shape
    fn = torch.cat([flow[:, 0:1] / ((x.shape[3] - 1.0) / 2.0),
                    flow[:, 1:2] / ((x.shape[2] - 1.0) / 2.0)], 1)
    g = (_base_grid(n, h, w, flow.device) + fn).permute(0, 2, 3, 1)
    return F.grid_sample(x, g, mode="bilinear", padding_mode="border",
                         align_corners=True)


def _multipliers(h: int, w: int) -> tuple[float, float]:
    """fl(1 / ((w - 1) / 2)), fl(1 / ((h - 1) / 2)): what PyTorch
    multiplies by when it divides an f32 tensor by those host scalars on
    the card."""
    one = np.float32(1.0)
    return (float(one / np.float32((w - 1.0) / 2.0)),
            float(one / np.float32((h - 1.0) / 2.0)))


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.dtype != dtype or t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"warp_grid: {name} must be {dtype} [n, c, h, w] "
                         f"with contiguous columns, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def warp_frames(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """f32 [n, C, h, w] frames (any batch, channel and row strides) warped
    by the f32 flows [n, 2, h, w] -> f32 [n, C, h, w]."""
    if use_plain(x):
        return warp_plain(x, flow)
    _check(x, "x", F32)
    _check(flow, "flow", F32)
    n, c, h, w = x.shape
    if flow.shape != (n, 2, h, w):
        raise ValueError(f"warp_grid: flow {tuple(flow.shape)} for frames "
                         f"{tuple(x.shape)}")
    out = torch.empty((n, c, h, w), dtype=F32, device=x.device)
    mx, my = _multipliers(h, w)
    launch("tpufg_warp_grid_f32", x, x.data_ptr(), *x.stride()[:3],
           flow.data_ptr(), *flow.stride()[:3],
           _linspace(w, x.device).data_ptr(),
           _linspace(h, x.device).data_ptr(), out.data_ptr(),
           *out.stride()[:3], n, c, h, w, mx, my, out=(out,))
    warp_frames.launches += 1
    return out


warp_frames.launches = 0


def warp_features_into_plain(out: torch.Tensor, offset: int,
                             feats: torch.Tensor, flow: torch.Tensor) -> None:
    out[:, offset:offset + feats.shape[1]].copy_(
        warp_plain(feats.float(), flow))


def warp_features_into(out: torch.Tensor, offset: int, feats: torch.Tensor,
                       flow: torch.Tensor) -> None:
    """Channels-last bf16 features [1, C, h, w] warped by the f32 flow
    [1, 2, h, w] (in f32, rounded to bf16), written into ``out``'s
    channels ``offset .. offset + C`` (channels-last bf16 [1, >= C, h,
    w])."""
    if use_plain(feats):
        warp_features_into_plain(out, offset, feats, flow)
        return
    c = feats.shape[1]
    cl = torch.channels_last
    for name, t in (("feats", feats), ("out", out)):
        if (t.dtype != BF16 or t.dim() != 4 or t.shape[0] != 1
                or not t.is_contiguous(memory_format=cl)):
            raise ValueError(f"warp_grid: {name} must be channels-last bf16 "
                             f"[1, c, h, w], got {t.dtype} {tuple(t.shape)}")
    _, ctot, h, w = out.shape
    if (feats.shape[2:] != out.shape[2:] or c % 8 or offset % 8
            or offset + c > ctot):
        raise ValueError(f"warp_grid: {c} channels at {offset} of "
                         f"{tuple(out.shape)} (multiples of 8)")
    _check(flow, "flow", F32)
    mx, my = _multipliers(h, w)
    launch("tpufg_warp_grid_bf16", feats, feats.data_ptr(), feats.stride(2),
           flow.data_ptr(), flow.stride(1), flow.stride(2),
           _linspace(w, feats.device).data_ptr(),
           _linspace(h, feats.device).data_ptr(),
           out.data_ptr() + 2 * offset, out.stride(2), out.stride(3), c, h,
           w, mx, my, out=(out,))
    warp_features_into.launches += 1


warp_features_into.launches = 0
