"""RAFT's convex upsampling (``core/raft.py``, ``upsample_flow``), for
``models/raft.py``: the 1/8-size flow f32 [1, 2, h, w] and the mask head's
output, bf16 [1, 576, h, w] (channel ``k * 64 + i * 8 + j``: tap k of the
3 x 3 neighbourhood, row i and column j of the 8 x 8 cell) -> the
full-size flow f32 [1, 2, 8h, 8w]: per pixel the softmax over its 9 logits
``0.25 mask`` (the published scale, exact in f32) weighting 8 x the 9
coarse flows around its cell (zeros outside).

``convex_upsample_plain`` is the published arithmetic with its sums in tap
order (``0.25 m`` in f32, ``exp(m - max) / sum``, then ``sum_k w_k * 8
flow_k``, one rounding per operation), which CPU tensors take; ``convex_upsample`` runs
``csrc/convex_upsample.cu`` on the card, bitwise the plain version.  The
published ``torch.softmax`` and ``torch.sum`` add the same terms in an
order of their own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32
BF16 = torch.bfloat16
CELL = 8


def convex_upsample_plain(flow: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    _, _, h, w = flow.shape
    m = 0.25 * mask.float().reshape(9, CELL * CELL, h, w)
    e = torch.exp(m - m.amax(0))
    s = e[0]
    for k in range(1, 9):
        s = s + e[k]
    wts = e / s
    f8 = F.pad(8 * flow[0], (1, 1, 1, 1))
    up = None
    for k in range(9):
        ky, kx = divmod(k, 3)
        term = wts[k][None] * f8[:, None, ky:ky + h, kx:kx + w]
        up = term if up is None else up + term
    return up.reshape(2, CELL, CELL, h, w).permute(0, 3, 1, 4, 2).reshape(
        1, 2, CELL * h, CELL * w)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """See the module's docstring; on the card the mask may be in either
    memory layout (it is read channels-last)."""
    if use_plain(flow):
        return convex_upsample_plain(flow, mask)
    _, _, h, w = flow.shape
    if flow.dtype != F32 or flow.shape != (1, 2, h, w) or (
            not flow.is_contiguous()):
        raise ValueError("convex_upsample: flow must be contiguous f32 "
                         f"[1, 2, h, w], got {flow.dtype} "
                         f"{tuple(flow.shape)}")
    if mask.dtype != BF16 or mask.shape != (1, 9 * CELL * CELL, h, w):
        raise ValueError("convex_upsample: mask must be bf16 "
                         f"[1, 576, {h}, {w}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    mask = mask.contiguous(memory_format=torch.channels_last)
    out = torch.empty((1, 2, CELL * h, CELL * w), dtype=F32,
                      device=flow.device)
    launch("tpufg_convex_upsample", flow, flow.data_ptr(), mask.data_ptr(),
           out.data_ptr(), h, w, out=(out,))
    convex_upsample.launches += 1
    return out


convex_upsample.launches = 0
