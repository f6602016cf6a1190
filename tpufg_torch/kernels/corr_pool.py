"""RAFT's correlation pyramid (``core/corr.py``, ``CorrBlock``), for
``models/raft.py``: levels 1-3 of the all-pairs correlation volume, each
``avg_pool2d(2, stride=2)`` of the level before, from level 0, f32 [n, 1,
h, w] (pixel p's map over every position) -> three f32 [n, 1, h_l, w_l],
each size halved and floored.

``corr_pool_plain`` is the published form (three ``F.avg_pool2d``
calls), which CPU tensors take; ``corr_pool`` runs ``csrc/corr_pool.cu``
on the card, one pass over level 0, bitwise the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32


def corr_pool_plain(level0: torch.Tensor) -> list:
    out = [level0]
    for _ in range(3):
        out.append(F.avg_pool2d(out[-1], 2, stride=2))
    return out[1:]


def corr_pool(level0: torch.Tensor) -> list:
    """Levels 1-3 of ``level0`` (see the module's docstring); on the card
    ``level0`` must be contiguous with h and w at least 8."""
    if use_plain(level0):
        return corr_pool_plain(level0)
    n, one, h, w = level0.shape
    if (level0.dtype != F32 or one != 1 or not level0.is_contiguous()
            or min(h, w) < 8):
        raise ValueError("corr_pool: level 0 must be contiguous f32 [n, 1, "
                         f"h, w] (h, w >= 8), got {level0.dtype} "
                         f"{tuple(level0.shape)}")
    out, hl, wl = [], h, w
    for _ in range(3):
        hl, wl = hl // 2, wl // 2
        out.append(torch.empty((n, 1, hl, wl), dtype=F32,
                               device=level0.device))
    launch("tpufg_corr_pool", level0, level0.data_ptr(), n, h, w,
           *(t.data_ptr() for t in out), out=tuple(out))
    corr_pool.launches += 1
    return out


corr_pool.launches = 0
