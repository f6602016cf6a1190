"""Frame bytes in and out: the UNORM8 read and store, the Lanczos-3
resample with its pack, and the y4m FRAME payload.

Frozen from the plain versions the port's kernels are held to:
- read: ``byte * fl(1/255)`` (a multiply by the f32 reciprocal);
- store: clamp to [0, 1], times 255, round half to even;
- Lanczos-a (the shader's stencil, renormalised over in-bounds taps,
  separable): per axis ``2a`` taps from f32 tables, the horizontal pass
  first, each a sequential sum over the taps in table order, all in f32;
- y4m: BT.601 limited range in 16.16 fixed point, int32 with an
  arithmetic ``>> 16``, C420 chroma as 2x2 sums rounded by ``(s + 2) >> 2``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

F32 = torch.float32
INV255 = 1.0 / 255.0
_PI = np.float32(3.14159265359)
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (f32) -> x rounded to the compute type and held in f32: bf16, or
    float8 e4m3 saturating at its largest finite value (the control)."""
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(F32)
    if precision == "fp8":
        return lambda x: x.clamp(-FP8_MAX, FP8_MAX).to(FP8).to(F32)
    raise ValueError(f"precision must be bf16 or fp8, got {precision!r}")


def to_u8(frame: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 4] or the packed int32 [H, W] wire -> uint8 [H, W, 4]."""
    if frame.dtype == torch.int32:
        return frame.contiguous().view(torch.uint8).reshape(
            *frame.shape, 4)
    return frame


def unpack(frame: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 4] -> planar f32 [4, H, W] in [0, 1]."""
    x = to_u8(frame).to(F32) * INV255
    return torch.movedim(x, -1, -3).contiguous()


def store(planar: torch.Tensor) -> torch.Tensor:
    """planar [4, H, W] -> uint8 [H, W, 4] (the UNORM8 store)."""
    x = torch.movedim(planar.to(F32), -3, -1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _lanczos_weight(x: np.ndarray, a: int) -> np.ndarray:
    x = x.astype(np.float32)
    px = _PI * x
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.float32(a) * np.sin(px) * np.sin(px / np.float32(a)) / (px * px)
    return np.where(x == 0, np.float32(1.0), w).astype(np.float32)


def axis_taps(in_size: int, out_size: int, a: int):
    """One axis of the resample: (index int64 [out, 2a], weight f32
    [out, 2a]); out-of-range taps weigh 0, the rest are divided by their
    sum, and their indices are clamped so every gather stays in bounds."""
    out_idx = np.arange(out_size, dtype=np.float32)
    uv = (out_idx + np.float32(0.5)) / np.float32(out_size)
    pos = uv * np.float32(in_size) - np.float32(0.5)
    fl = np.floor(pos)
    frac = (pos - fl).astype(np.float32)
    start = fl - np.float32(a - 1)
    k = np.arange(2 * a, dtype=np.float32)
    coords = (start[:, None] + k[None, :]).astype(np.int32)
    deltas = (k[None, :] - frac[:, None] - np.float32(a - 1)).astype(
        np.float32)
    valid = (coords >= 0) & (coords <= in_size - 1)
    w = np.where(valid, _lanczos_weight(deltas, a), np.float32(0.0)).astype(
        np.float32)
    wsum = np.sum(w, axis=1, keepdims=True, dtype=np.float32)
    w = (w / np.maximum(wsum, np.float32(1e-30))).astype(np.float32)
    idx = np.clip(coords, 0, in_size - 1).astype(np.int64)
    return idx, w


@functools.lru_cache(maxsize=8)
def _taps_on(in_size: int, out_size: int, a: int, device: torch.device):
    idx, w = axis_taps(in_size, out_size, a)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def lanczos(img: torch.Tensor, out_h: int, out_w: int,
            a: int = 3) -> torch.Tensor:
    """[C, H, W] -> f32 [C, out_h, out_w]: horizontal pass, then
    vertical, each a sequential sum over the taps."""
    _, in_h, in_w = img.shape
    x = img.to(F32)
    ix, wx = _taps_on(in_w, out_w, a, x.device)
    iy, wy = _taps_on(in_h, out_h, a, x.device)
    tmp = x[:, :, ix[:, 0]] * wx[:, 0]
    for k in range(1, 2 * a):
        tmp = tmp + x[:, :, ix[:, k]] * wx[:, k]
    out = tmp[:, iy[:, 0], :] * wy[:, 0, None]
    for k in range(1, 2 * a):
        out = out + tmp[:, iy[:, k], :] * wy[:, k, None]
    return out


def scale_store(img: torch.Tensor, out_h: int, out_w: int,
                a: int = 3) -> torch.Tensor:
    """[4, H, W] -> uint8 [out_h, out_w, 4]: the resample, then the store."""
    return store(lanczos(img, out_h, out_w, a))


def y4m_payload(frame: torch.Tensor, chroma: str = "420") -> torch.Tensor:
    """uint8 [H, W, 4] -> the y4m FRAME payload, uint8 [rows, W]."""
    u8 = to_u8(frame).to(torch.int32)
    r, g, b = u8[..., 0], u8[..., 1], u8[..., 2]
    h, w = r.shape
    y = ((16829 * r + 33039 * g + 6416 * b) >> 16) + 16
    u = ((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128
    v = ((28784 * r - 24103 * g - 4681 * b) >> 16) + 128
    y, u, v = (torch.clamp(p, 0, 255) for p in (y, u, v))
    if chroma == "420":
        u, v = (((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                  + p[1::2, 1::2]) + 2) >> 2 for p in (u, v))
        rows = h * 3 // 2
    elif chroma == "444":
        rows = 3 * h
    else:
        raise ValueError(f"chroma must be 420 or 444, got {chroma!r}")
    return torch.cat([p.reshape(-1) for p in (y, u, v)]).to(
        torch.uint8).reshape(rows, w)
