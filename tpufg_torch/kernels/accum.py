"""An IFBlock's output added into the IFNet's flow and mask
(``models/ifnet.py``): the block's last transposed conv ``t`` resized by
2S (bilinear, ``align_corners=False``) and added into the f32 state
[1, 5, H, W], its flow channels times 2S.

``ifnet_accum_plain`` is the published arithmetic in plain torch (CPU
tensors take it); on the card ``ifnet_accum`` runs
``csrc/ifnet_accum.cu``, one pass, bitwise equal.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import launch, use_plain

F32 = torch.float32
BF16 = torch.bfloat16


@functools.lru_cache(maxsize=16)
def _scales(mult: float, device: torch.device) -> torch.Tensor:
    """[1, 5, 1, 1]: ``mult`` on the flow's channels, 1 on the mask's."""
    return torch.tensor([mult] * 4 + [1.0], dtype=F32,
                        device=device).view(1, 5, 1, 1)


def ifnet_accum_plain(t: torch.Tensor, state: torch.Tensor | None,
                      scale: float) -> torch.Tensor:
    """``t`` [1, >= 5, h, w] (its first 5 channels) resized by ``2 *
    scale`` into f32 [1, 5, 2Sh, 2Sw], times (2S, 2S, 2S, 2S, 1), added
    into ``state`` in place (None: the product itself)."""
    up = F.interpolate(t[:, :5].float().contiguous(), scale_factor=scale * 2,
                       mode="bilinear", align_corners=False)
    if state is None:
        up[:, :4] *= scale * 2
        return up
    return state.addcmul_(up, _scales(scale * 2, up.device))


def ifnet_accum(t: torch.Tensor, state: torch.Tensor | None,
                scale: float) -> torch.Tensor:
    """:func:`ifnet_accum_plain` in one launch on the card (``t``
    channels-last bf16, ``state`` contiguous f32)."""
    if use_plain(t):
        return ifnet_accum_plain(t, state, scale)
    _, c, th, tw = t.shape
    mult = scale * 2
    h, w = int(th * mult), int(tw * mult)
    if (t.dtype != BF16 or t.shape[0] != 1 or c < 5
            or not t.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("ifnet_accum: t must be channels-last bf16 [1, >= 5, "
                         f"h, w], got {t.dtype} {tuple(t.shape)}")
    if state is None:
        out = torch.empty((1, 5, h, w), dtype=F32, device=t.device)
    elif (state.dtype != F32 or state.shape != (1, 5, h, w)
          or not state.is_contiguous()):
        raise ValueError(f"ifnet_accum: state must be f32 [1, 5, {h}, {w}]")
    else:
        out = state
    launch("tpufg_ifnet_accum", t, t.data_ptr(), c, th, tw, out.data_ptr(),
           h, w, 1.0 / mult, mult, int(state is None), out=(out,))
    ifnet_accum.launches += 1
    return out


ifnet_accum.launches = 0
