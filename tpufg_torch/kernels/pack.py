"""f32 planes -> one channels-last bf16 tensor with zero channels past
them: the input of one of the IFNet's convs (``models/ifnet.py``).

``pack_nhwc_plain`` writes each piece into its channel slice of a
channels-last bf16 buffer (CPU tensors take it); on the card
``pack_nhwc`` runs ``csrc/pack_nhwc.cu``, one pass that reads each plane
once and writes each pixel's channels as 16-byte stores.  Both round to
bf16 as PyTorch converts (to nearest, ties to even), so they are bitwise
equal.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

BF16 = torch.bfloat16
F32 = torch.float32


def _flat(pieces) -> list:
    """Each piece [n, c, h, w] as [1, n * c, h, w] (batch-major, as
    ``cat([t[0], t[1], ..])`` along channels)."""
    return [t.reshape(1, -1, *t.shape[2:]) for t in pieces]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[1, c, H, W] -> [1, 4c, H / 2, W / 2], channel ``phase * c + k``
    holding channel k's pixels at row parity ``phase // 2`` and column
    parity ``phase % 2``."""
    _, c, h, w = x.shape
    return x.reshape(1, c, h // 2, 2, w // 2, 2).permute(
        0, 3, 5, 1, 2, 4).reshape(1, 4 * c, h // 2, w // 2)


def pack_nhwc_plain(pieces, channels: int, s2d: bool = False
                    ) -> torch.Tensor:
    pieces = _flat(pieces)
    if s2d:
        x = torch.cat(pieces, 1)
        pieces = [F.pad(space_to_depth(x), (1, 0, 1, 0))]
    _, _, h, w = pieces[0].shape
    buf = torch.empty((1, channels, h, w), dtype=BF16,
                      device=pieces[0].device,
                      memory_format=torch.channels_last)
    c = 0
    for t in pieces:
        buf[:, c:c + t.shape[1]].copy_(t)
        c += t.shape[1]
    if c < channels:
        buf[:, c:].zero_()
    return buf


def pack_nhwc(pieces, channels: int, s2d: bool = False) -> torch.Tensor:
    """``cat(pieces)`` along channels (each f32 [n, c, h, w], batch-major)
    as a channels-last bf16 [1, channels, h, w], the channels past them
    zero (``channels`` a multiple of 8, at most 32, on the card).  With
    ``s2d``: :func:`space_to_depth` of it behind a zero row and column,
    [1, channels, h / 2 + 1, w / 2 + 1] (h and w even)."""
    first = pieces[0]
    if use_plain(first):
        return pack_nhwc_plain(pieces, channels, s2d)
    _, _, h, w = first.shape
    ptrs, rows = [], []
    for t in pieces:
        if t.dtype != F32 or t.dim() != 4 or t.shape[2:] != (h, w) or (
                t.stride(3) != 1):
            raise ValueError("pack_nhwc: pieces must be f32 [n, c, h, w] "
                             "with contiguous columns, got "
                             f"{t.dtype} {tuple(t.shape)} {t.stride()}")
        for b in range(t.shape[0]):
            for c in range(t.shape[1]):
                ptrs.append(t.data_ptr() + 4 * (b * t.stride(0)
                                                + c * t.stride(1)))
                rows.append(t.stride(2))
    need = 4 * len(ptrs) if s2d else len(ptrs)
    if channels % 8 or channels > 32 or not 0 < need <= channels or (
            s2d and (h % 2 or w % 2)):
        raise ValueError(f"pack_nhwc: {len(ptrs)} planes into {channels} "
                         "channels (a multiple of 8, at most 32)")
    oh, ow = (h // 2 + 1, w // 2 + 1) if s2d else (h, w)
    out = torch.empty((1, channels, oh, ow), dtype=BF16, device=first.device,
                      memory_format=torch.channels_last)
    arr = ctypes.c_int64 * len(ptrs)
    launch("tpufg_pack_nhwc", first, arr(*ptrs), arr(*rows), len(ptrs),
           int(s2d), out.data_ptr(), channels, oh, ow, out=(out,))
    pack_nhwc.launches += 1
    return out


pack_nhwc.launches = 0
