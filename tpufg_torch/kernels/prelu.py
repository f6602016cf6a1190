"""The bias add and PReLU of RIFE's IFNet (``models/ifnet.py``) after a
bias-free cuDNN conv: ``y = q(prelu(q(y + b), a))`` per channel, ``q`` the
round to bf16, on a channels-last bf16 [N, C, H, W] tensor.

``bias_prelu`` is the kernel (``csrc/bias_prelu.cu``: one pass, in place
or into one or two channel slices of wider tensors, the U-Net's
concatenations); ``bias_prelu_plain`` the plain version, which CPU tensors
take.
Both are bitwise what PyTorch's bf16 ``y + b`` and ``F.prelu`` give, one
after the other.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import launch, use_plain

BF16 = torch.bfloat16


def bias_prelu_plain(y: torch.Tensor, bias: torch.Tensor,
                     slope: torch.Tensor, out: torch.Tensor | None = None,
                     out2: torch.Tensor | None = None) -> torch.Tensor:
    """A new bf16 tensor of ``y``'s layout; with ``out`` (and ``out2``),
    copied into them and ``out`` returned."""
    x = (y.float() + bias.float()[None, :, None, None]).to(BF16).float()
    r = torch.where(x > 0, x, slope.float()[None, :, None, None]
                    * x).to(BF16)
    for o in (out, out2):
        if o is not None:
            o.copy_(r)
    return r if out is None else out


def _slice_ok(t: torch.Tensor, c: int, hw) -> bool:
    """A channel slice [1, c, h, w] of a channels-last bf16 tensor whose
    pixels the kernel can write as 16-byte groups."""
    return (t.dtype == BF16 and t.dim() == 4 and t.shape[:2] == (1, c)
            and tuple(t.shape[2:]) == tuple(hw) and t.stride(1) == 1
            and t.stride(2) == t.shape[3] * t.stride(3)
            and t.stride(3) % 8 == 0 and t.data_ptr() % 16 == 0)


def bias_prelu(y: torch.Tensor, bias: torch.Tensor, slope: torch.Tensor,
               out: torch.Tensor | None = None,
               out2: torch.Tensor | None = None) -> torch.Tensor:
    """``y`` with the bias added and the PReLU applied, in place on a CUDA
    tensor (channels-last bf16, C a multiple of 8, at most 1024), a new
    tensor on the CPU; or, with ``out`` (and ``out2``), written into those
    channel slices of wider channels-last bf16 tensors, ``out``
    returned."""
    if use_plain(y):
        return bias_prelu_plain(y, bias, slope, out, out2)
    n, c = y.shape[:2]
    if (y.dtype != BF16 or y.dim() != 4 or c % 8 or y.data_ptr() % 16
            or not y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("bias_prelu: expected a channels-last bf16 [N, C, "
                         "H, W] tensor, C a multiple of 8, got "
                         f"{y.dtype} {tuple(y.shape)}")
    for name, t in (("bias", bias), ("slope", slope)):
        if t.dtype != BF16 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"bias_prelu: {name} must be bf16 [{c}]")
    if c > 1024:
        raise ValueError(f"bias_prelu: {c} channels (at most 1024)")
    for t in (out, out2):
        if t is not None and (n != 1 or not _slice_ok(t, c, y.shape[2:])):
            raise ValueError("bias_prelu: out must be a 16-byte aligned "
                             f"channel slice [1, {c}, h, w] of a "
                             "channels-last bf16 tensor")
    launch("tpufg_bias_prelu", y, y.data_ptr(), bias.data_ptr(),
           slope.data_ptr(), y.numel(), c,
           None if out is None else out.data_ptr(),
           0 if out is None else out.stride(3),
           None if out2 is None else out2.data_ptr(),
           0 if out2 is None else out2.stride(3),
           out=(y if out is None else out,))
    bias_prelu.launches += 1
    return y if out is None else out


bias_prelu.launches = 0
