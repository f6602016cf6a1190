"""RAFT's correlation pyramid lookup (``core/corr.py``, ``CorrBlock``), for
``models/raft.py``: the 9 x 9 window of radius 4 around each pixel's
coordinates on the 4 levels of its all-pairs correlation map, sampled
bilinearly (zeros outside), as the motion encoder's first conv reads it:
a channels-last bf16 [1, 328, h, w], channel ``l * 81 + a * 9 + b`` the
sample at offset (x, y) = (a - 4, b - 4) on level l, channels 324-327
zero (the conv's input width padded to a multiple of 8).

``corr_lookup_plain`` is the published form (four ``grid_sample`` calls
through ``bilinear_sampler``'s normalise, ``cat``), which CPU tensors
take; on the card it runs ATen's own sampler (cuDNN's is switched off
around the call: its sums are its own).  ``corr_lookup`` runs
``csrc/corr_lookup.cu`` on the card, bitwise the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32
BF16 = torch.bfloat16
RADIUS = 4
LEVELS = 4
TAPS = LEVELS * (2 * RADIUS + 1) ** 2     # 324
CHANNELS = 328                            # TAPS padded to a multiple of 8


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``utils/utils.py``'s ``bilinear_sampler``: ``grid_sample`` of
    ``img`` [n, 1, h, w] at pixel coordinates ``coords`` [n, a, b, 2]
    (x, y), ``align_corners=True``, zeros outside."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic,
                     allow_tf32=cudnn.allow_tf32):
        return F.grid_sample(img, grid, align_corners=True)


def corr_lookup_plain(pyramid, coords: torch.Tensor) -> torch.Tensor:
    """``pyramid``: the 4 levels, f32 [h * w, 1, h_l, w_l]; ``coords``:
    f32 [1, 2, h, w] (x, y) -> bf16 channels-last [1, 328, h, w]."""
    _, _, h, w = coords.shape
    c = coords.permute(0, 2, 3, 1)
    d = torch.linspace(-RADIUS, RADIUS, 2 * RADIUS + 1, device=coords.device)
    # corr.py's meshgrid(dy, dx): the x offset varies along the first index
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    out = []
    for i, corr in enumerate(pyramid):
        centroid = c.reshape(h * w, 1, 1, 2) / 2 ** i
        out.append(bilinear_sampler(corr, centroid + delta.view(
            1, 2 * RADIUS + 1, 2 * RADIUS + 1, 2)).view(1, h, w, -1))
    out = F.pad(torch.cat(out, dim=-1), (0, CHANNELS - TAPS))
    return out.to(BF16).permute(0, 3, 1, 2)


def corr_lookup(pyramid, coords: torch.Tensor) -> torch.Tensor:
    """The lookup at ``coords`` (see :func:`corr_lookup_plain`)."""
    if use_plain(coords):
        return corr_lookup_plain(pyramid, coords)
    _, _, h, w = coords.shape
    n = h * w
    if coords.dtype != F32 or coords.shape != (1, 2, h, w) or (
            not coords.is_contiguous()):
        raise ValueError("corr_lookup: coords must be contiguous f32 "
                         f"[1, 2, h, w], got {coords.dtype} "
                         f"{tuple(coords.shape)}")
    if len(pyramid) != LEVELS:
        raise ValueError(f"corr_lookup: {len(pyramid)} levels, expected "
                         f"{LEVELS}")
    hs, ws = [], []
    for t in pyramid:
        if (t.dtype != F32 or t.dim() != 4 or t.shape[:2] != (n, 1)
                or not t.is_contiguous() or min(t.shape[2:]) < 2):
            raise ValueError("corr_lookup: each level must be contiguous f32 "
                             f"[{n}, 1, h, w] (h, w >= 2), got {t.dtype} "
                             f"{tuple(t.shape)}")
        hs.append(t.shape[2])
        ws.append(t.shape[3])
    one = np.float32(1.0)
    out = torch.empty((1, CHANNELS, h, w), dtype=BF16, device=coords.device,
                      memory_format=torch.channels_last)
    launch("tpufg_corr_lookup", coords,
           (ctypes.c_void_p * LEVELS)(*(t.data_ptr() for t in pyramid)),
           (ctypes.c_int * LEVELS)(*hs), (ctypes.c_int * LEVELS)(*ws),
           (ctypes.c_float * LEVELS)(*(float(one / np.float32(v - 1))
                                       for v in ws)),
           (ctypes.c_float * LEVELS)(*(float(one / np.float32(v - 1))
                                       for v in hs)),
           coords.data_ptr(), n, out.data_ptr(), CHANNELS, out=(out,))
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0
