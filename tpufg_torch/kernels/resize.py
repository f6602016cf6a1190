"""Aligned 2x box downsample (the pyramid's level construction).

Counterpart of ``tpufg/kernels/resize.py``.  The TPU kernel expresses the
2x2 mean as two banded 0.5-weight matmuls (vertical pair first); the CUDA
kernel (csrc/box2.cu) and the plain version below compute the same two
roundings directly, so all three agree bitwise.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, on_cpu


def _check_even(img: torch.Tensor) -> None:
    if img.dim() != 3:
        raise ValueError(f"box_downsample2 takes [C, H, W], got "
                         f"{tuple(img.shape)}")
    _, h, w = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"box_downsample2 needs even dims, got {h}x{w}")


def box_downsample2_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain torch [C, H, W] -> [C, H/2, W/2] 2x2 mean, vertical pair
    first: 0.5*(0.5*a + 0.5*c) + 0.5*(0.5*b + 0.5*d) in f32."""
    _check_even(img)
    x = img.to(torch.float32)
    v0 = 0.5 * x[:, 0::2, 0::2] + 0.5 * x[:, 1::2, 0::2]
    v1 = 0.5 * x[:, 0::2, 1::2] + 0.5 * x[:, 1::2, 1::2]
    return 0.5 * v0 + 0.5 * v1


def box_downsample2(img: torch.Tensor) -> torch.Tensor:
    """[C, H, W] f32 -> [C, H/2, W/2] 2x2 box mean (H, W even).

    CUDA tensors run csrc/box2.cu (one thread per output element); CPU
    tensors take :func:`box_downsample2_plain`.
    """
    _check_even(img)
    if on_cpu(img):
        return box_downsample2_plain(img)
    check_kernel_input(img, "box_downsample2", torch.float32, 3)
    c, h, w = img.shape
    out = torch.empty((c, h // 2, w // 2), dtype=torch.float32,
                      device=img.device)
    launch("tpufg_box2", img, img.data_ptr(), out.data_ptr(), c, h, w)
    box_downsample2.launches += 1
    return out


box_downsample2.launches = 0
