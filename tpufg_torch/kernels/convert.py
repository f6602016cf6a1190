"""Frame layout conversion: packed RGBA wire <-> planar compute layout.

Counterpart of ``tpufg/kernels/convert.py``.  Frames arrive as uint8
[H, W, 4] RGBA or as the packed-int32 wire (the same bytes viewed as one
little-endian int32 per pixel, channel c in byte c) and become planar f32
[4, H, W] in [0, 1] (UNORM read: byte * fl(1/255), see
``frames_to_planar_plain``).  Egress quantizes with the UNORM8 store
convention (clamp, *255, round half to even).

``frames_to_planar`` is the kernel of this module (csrc/unpack.cu); the
egress helpers are plain torch, as they are plain XLA in the reference.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain

#: fl(1/255), the f32 reciprocal tpufg's compiled UNORM read multiplies by
INV255 = 1.0 / 255.0


def _as_u8(frames: torch.Tensor) -> torch.Tensor:
    """int32 [H, W] wire -> its uint8 [H, W, 4] bytes; uint8 passes."""
    if frames.dtype == torch.int32 and frames.dim() == 2:
        return frames.contiguous().view(torch.uint8).reshape(
            *frames.shape, 4)
    if frames.dtype == torch.uint8 and frames.dim() >= 3:
        return frames
    raise ValueError("frames must be uint8 [..., H, W, C] or the int32 "
                     f"[H, W] wire, got {frames.dtype} {tuple(frames.shape)}")


def frames_to_planar_plain(frames: torch.Tensor) -> torch.Tensor:
    """Plain torch unpack: uint8 [..., H, W, C] or int32 [H, W] -> f32
    planar [..., C, H, W] = byte * fl(1/255).

    A multiply by the f32 reciprocal, not a divide: tpufg's source writes
    x / 255, but XLA compiles a division by a constant into a multiply by
    its reciprocal (seen in the CPU backend's optimized HLO), and tpufg's
    TPU unpack kernel multiplies explicitly.  The two forms differ in the
    last bit for 126 of the 256 codes; multiplying keeps the port bitwise
    equal to tpufg.
    """
    u8 = _as_u8(frames)
    x = u8.to(torch.float32) * INV255
    return torch.movedim(x, -1, -3).contiguous()


def frames_to_planar(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 4] or int32 [H, W] wire -> f32 planar [4, H, W].

    CUDA tensors run the unpack kernel (csrc/unpack.cu: one int32 read and
    four f32 writes per pixel, bitwise equal to the plain version); CPU
    tensors take :func:`frames_to_planar_plain`, which also accepts other
    channel counts and leading batch axes.
    """
    if use_plain(frames):
        return frames_to_planar_plain(frames)
    if frames.dtype == torch.uint8:
        if frames.dim() != 3 or frames.shape[-1] != 4:
            raise ValueError("the unpack kernel takes uint8 [H, W, 4], got "
                             f"{tuple(frames.shape)}")
        frames = frames.contiguous().view(torch.int32).reshape(
            frames.shape[:2])
    check_kernel_input(frames, "frames_to_planar", torch.int32, 2)
    h, w = frames.shape
    out = torch.empty((4, h, w), dtype=torch.float32, device=frames.device)
    launch("tpufg_unpack", frames, frames.data_ptr(), out.data_ptr(), h, w,
           out=(out,))
    frames_to_planar.launches += 1
    return out


frames_to_planar.launches = 0


def planar_to_frames(planar: torch.Tensor) -> torch.Tensor:
    """planar [..., C, H, W] float -> uint8 [..., H, W, C] (UNORM8 store:
    clamp to [0, 1], *255, round half to even)."""
    x = torch.movedim(planar.to(torch.float32), -3, -1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def planar_to_i32(planar: torch.Tensor) -> torch.Tensor:
    """planar [4, H, W] float -> packed int32 [H, W] wire: the bytes of
    :func:`planar_to_frames` viewed as little-endian int32 lanes."""
    u8 = planar_to_frames(planar).contiguous()
    return u8.view(torch.int32).squeeze(-1)
