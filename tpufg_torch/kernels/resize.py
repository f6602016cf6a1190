"""Aligned 2x box downsample (the pyramid's level construction), and the
linear resize tpufg takes from ``jax.image.resize``.

Counterpart of ``tpufg/kernels/resize.py``.  The TPU kernel expresses the
2x2 mean as two banded 0.5-weight matmuls (vertical pair first); the CUDA
kernel (csrc/box2.cu) and the plain version below compute the same two
roundings directly, so all three agree bitwise.

:func:`resize_linear` is ``jax.image.resize(x, shape, "linear")`` for
upsampling (tpufg's MV upsample, the per-column warp offsets, the
per-pixel OOB mask and the MC fallback's cell means): the weights of
``jax/_src/image/scale.py::compute_weight_mat`` (f32 sample points
``(i + 0.5) / scale - 0.5``, triangle weights normalised by their column
sum, zero where a sample point leaves ``[-0.5, n_in - 0.5]``), at most two
taps per output, one contraction per axis from the last axis to the first
(the order of jax's einsum).  Each contraction rounds as XLA's CPU dot
does: the lower tap's product rounded to f32, then the upper tap fused
into it with one rounding (computed in f64, where the f32 product is
exact), or, for the axes named in ``sum_axes``, the two rounded products
added.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain


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
    if use_plain(img):
        return box_downsample2_plain(img)
    check_kernel_input(img, "box_downsample2", torch.float32, 3)
    c, h, w = img.shape
    out = torch.empty((c, h // 2, w // 2), dtype=torch.float32,
                      device=img.device)
    launch("tpufg_box2", img, img.data_ptr(), out.data_ptr(), c, h, w,
           out=(out,))
    box_downsample2.launches += 1
    return out


box_downsample2.launches = 0


class LinearTaps(NamedTuple):
    """The two taps of every output of a linear upsample along one axis:
    output j reads inputs ``i0[j]`` and ``i1[j] = min(i0[j] + 1, n_in - 1)``
    with f32 weights ``w0[j]`` and ``w1[j]`` (``w1`` is 0 where one tap
    holds the whole weight).  ``i0`` and ``i1`` are int64 for indexing,
    ``i0_i32`` the int32 table a CUDA kernel reads."""
    i0: torch.Tensor
    i1: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor
    i0_i32: torch.Tensor


@functools.lru_cache(maxsize=64)
def _linear_taps_np(n_in: int, n_out: int):
    """``compute_weight_mat``'s weights for ``n_in`` -> ``n_out`` (an
    upsample) as (i0, w0, w1) numpy arrays."""
    if n_out < n_in:
        raise ValueError(f"resize_linear upsamples only, got {n_in} -> "
                         f"{n_out}")
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    s = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(s[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x)
    # at most two weights of a column are non-zero: their sum is exact in
    # any order
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000 * np.finfo(f32).eps,
                 w / np.where(tot != 0, tot, f32(1)), f32(0)).astype(f32)
    w = np.where(((s >= -0.5) & (s <= n_in - 0.5))[None, :], w,
                 f32(0)).astype(f32)
    nz = w != 0
    i0 = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    cols = np.arange(n_out)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w0 = w[i0, cols]
    w1 = np.where(i1 != i0, w[i1, cols], f32(0)).astype(f32)
    assert np.count_nonzero(nz) == np.count_nonzero(w0) + np.count_nonzero(w1)
    return i0, w0, w1


@functools.lru_cache(maxsize=64)
def linear_taps(n_in: int, n_out: int,
                device: torch.device = torch.device("cpu")) -> LinearTaps:
    """The taps of ``n_in`` -> ``n_out`` on ``device`` (made once)."""
    i0, w0, w1 = _linear_taps_np(n_in, n_out)
    i1 = np.minimum(i0 + 1, n_in - 1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LinearTaps(dev(i0.astype(np.int64)), dev(i1.astype(np.int64)),
                      dev(w0), dev(w1), dev(i0.astype(np.int32)))


def fused_lerp(a: torch.Tensor, w0: torch.Tensor, b: torch.Tensor,
               w1: torch.Tensor) -> torch.Tensor:
    """``b * w1`` fused into ``fl(a * w0) + 0`` with one rounding (as
    ``fmaf``; the f64 sum of the f32 value and the exact f32 product)."""
    p = a * w0 + 0.0
    return (p.double() + b.double() * w1.double()).float()


def resize_linear(x: torch.Tensor, shape, sum_axes=()) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")`` for an upsample of an f32
    tensor (axes of equal size are left alone).  ``sum_axes``: the axes
    whose contraction adds two rounded products instead of fusing the
    upper one (the form XLA's CPU dot takes for the second contraction of
    tpufg's MV upsample)."""
    out = x.to(torch.float32)
    if len(shape) != out.dim():
        raise ValueError(f"shape {tuple(shape)} for a {out.dim()}-d tensor")
    for d in reversed(range(out.dim())):
        n_in, n_out = out.shape[d], int(shape[d])
        if n_in == n_out:
            continue
        t = linear_taps(n_in, n_out, out.device)
        bshape = (n_out,) + (1,) * (out.dim() - d - 1)
        w0, w1 = t.w0.view(bshape), t.w1.view(bshape)
        a, b = out.index_select(d, t.i0), out.index_select(d, t.i1)
        if d in sum_axes:
            out = (a * w0 + 0.0) + b * w1
        else:
            out = fused_lerp(a, w0, b, w1)
    return out
