"""The IFNet's last step (``models/ifnet.py``): the U-Net's sigmoid and
residual, the mask-weighted merge of both warped frames, the clamp and the
crop back from the padded frame.

``ifnet_merge_plain`` is the published arithmetic in plain torch (CPU
tensors take it); on the card ``ifnet_merge`` runs ``csrc/ifnet_merge.cu``,
one pass with the same roundings, bitwise equal.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32
BF16 = torch.bfloat16


def ifnet_merge_plain(warped: torch.Tensor, sig: torch.Tensor,
                      u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``clamp(W0 sig + W1 (1 - sig) + res, 0, 1)[:, :h, :w]`` as f32
    [4, h, w]: ``warped`` f32 [2, 4, H, W], ``sig`` sigmoid(mask) f32
    [1, 1, H, W], ``u`` the final conv's output space-to-depth by 2,
    [1, >= 12, H / 2, W / 2] (channel ``3 phase + c``, phase ``2 (y % 2)
    + x % 2``), ``res = 2 sigmoid(u) - 1`` on RGB and 0 on alpha."""
    _, _, hs, ws = u.shape
    u = u[:, :12].reshape(1, 2, 2, 3, hs, ws).permute(0, 3, 4, 1, 5, 2)
    r = torch.sigmoid(u.reshape(1, 3, 2 * hs, 2 * ws).float())
    merged = warped[0:1] * sig + warped[1:2] * (1 - sig)
    merged[:, :3] += r * 2 - 1
    return merged.clamp_(0, 1)[0, :, :h, :w].contiguous()


def ifnet_merge(warped: torch.Tensor, sig: torch.Tensor, u: torch.Tensor,
                h: int, w: int) -> torch.Tensor:
    """:func:`ifnet_merge_plain` in one kernel launch on the card (``u``
    channels-last bf16, ``warped`` and ``sig`` f32 with contiguous
    columns)."""
    if use_plain(warped):
        return ifnet_merge_plain(warped, sig, u, h, w)
    _, _, hp, wp = warped.shape
    if (warped.dtype != F32 or warped.shape[:2] != (2, 4)
            or warped.stride(3) != 1 or sig.dtype != F32
            or sig.shape != (1, 1, hp, wp) or sig.stride(3) != 1
            or u.dtype != BF16 or u.shape[0] != 1 or u.shape[1] < 12
            or u.shape[2:] != (hp // 2, wp // 2)
            or not u.is_contiguous(memory_format=torch.channels_last)
            or not (0 < h <= hp and 0 < w <= wp)):
        raise ValueError("ifnet_merge: expected warped f32 [2, 4, H, W], sig "
                         "f32 [1, 1, H, W], u channels-last bf16 [1, >= 12, "
                         f"H / 2, W / 2], got {tuple(warped.shape)}, "
                         f"{tuple(sig.shape)}, "
                         f"{u.dtype} {tuple(u.shape)}")
    out = torch.empty((4, h, w), dtype=F32, device=warped.device)
    launch("tpufg_ifnet_merge", warped, warped.data_ptr(), *warped.stride()[:3],
           sig.data_ptr(), sig.stride(2), u.data_ptr(), u.shape[1],
           u.stride(2), out.data_ptr(), h, w, out=(out,))
    ifnet_merge.launches += 1
    return out


ifnet_merge.launches = 0
