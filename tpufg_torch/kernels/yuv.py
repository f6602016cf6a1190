"""Device-side y4m egress: RGBA wire -> YUV4MPEG2 FRAME payload.

Counterpart of ``tpufg/kernels/yuv.py``.  A y4m sink writes BT.601
limited-range Y, Cb, Cr planes; converting on the device means what crosses
to the host is the finished FRAME payload (12.4 MB for a 4K C420 frame
against 33.2 MB of RGBA) and the host's write is one buffer copy.

The arithmetic is the host egress's (``io/sinks.py`` ``_rgb_to_bt601`` and
``_down2x2``): 16.16 fixed point in int32 with an arithmetic ``>> 16``, the
limited-range offsets, a clip to [0, 255], and C420 chroma as 2x2 sums
rounded by ``(s + 2) >> 2``.  All of it is exact integer math, so the CUDA
kernel (csrc/yuv.cu, one pass), the plain torch version and the host
egress agree byte for byte.  On a CPU tensor :func:`rgba_to_y4m_payload`
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import check_kernel_input, launch, use_plain

I32 = torch.int32


def _as_i32(frame: torch.Tensor) -> torch.Tensor:
    """int32 [H, W] wire or uint8 [H, W, 4] -> the int32 [H, W] wire."""
    if frame.dim() == 3:
        if frame.shape[-1] != 4 or frame.dtype != torch.uint8:
            raise ValueError(f"expected uint8 [H, W, 4], got "
                             f"{frame.dtype} {tuple(frame.shape)}")
        return frame.contiguous().view(I32).reshape(frame.shape[:2])
    if frame.dim() != 2 or frame.dtype != I32:
        raise ValueError("expected the int32 [H, W] wire or uint8 "
                         f"[H, W, 4], got {frame.dtype} {tuple(frame.shape)}")
    return frame


def _check_chroma(h: int, w: int, chroma: str) -> None:
    if chroma not in ("420", "444"):
        raise ValueError(f"chroma must be 420 or 444, got {chroma!r}")
    if not y4m_wire_ok(h, w, chroma):
        raise ValueError(
            f"C420 payload needs H % 4 == 0 and W % 2 == 0, got {h}x{w}")


def rgba_to_y4m_payload_plain(frame: torch.Tensor,
                              chroma: str = "420") -> torch.Tensor:
    """Plain torch payload: int32 ops throughout (torch's ``>>`` on int32
    is arithmetic, as C's and numpy's are)."""
    q = _as_i32(frame)
    h, w = q.shape
    _check_chroma(h, w, chroma)
    r, g, b = q & 0xFF, (q >> 8) & 0xFF, (q >> 16) & 0xFF
    y = ((16829 * r + 33039 * g + 6416 * b) >> 16) + 16
    u = ((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128
    v = ((28784 * r - 24103 * g - 4681 * b) >> 16) + 128
    y, u, v = (torch.clamp(p, 0, 255) for p in (y, u, v))
    if chroma == "420":
        u, v = (((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
                  + p[1::2, 1::2]) + 2) >> 2 for p in (u, v))
    # the chroma planes' rows reinterpreted as payload rows: row-major bytes
    return torch.cat([p.reshape(-1) for p in (y, u, v)]).to(
        torch.uint8).reshape(payload_shape(h, w, chroma))


def rgba_to_y4m_payload(frame: torch.Tensor,
                        chroma: str = "420") -> torch.Tensor:
    """Packed-RGBA frame -> y4m FRAME payload bytes.

    ``frame``: the int32 [H, W] wire (channel c in byte c) or uint8
    [H, W, 4].  Returns uint8 [H*3//2, W] (C420; H % 4 == 0, W % 2 == 0)
    or [3*H, W] (C444) whose row-major bytes are the Y, then the Cb, then
    the Cr plane, ready to write after ``b"FRAME\\n"``.

    CUDA tensors run csrc/yuv.cu (16-byte loads where the width is a
    multiple of 4 and the frame is 16-byte aligned, else the scalar walk);
    CPU tensors take :func:`rgba_to_y4m_payload_plain`.
    """
    if use_plain(frame):
        return rgba_to_y4m_payload_plain(frame, chroma)
    q = _as_i32(frame).contiguous()
    h, w = q.shape
    _check_chroma(h, w, chroma)
    check_kernel_input(q, "rgba_to_y4m_payload", I32, 2)
    out = torch.empty(payload_shape(h, w, chroma), dtype=torch.uint8,
                      device=q.device)
    vec = int(w % 4 == 0 and q.data_ptr() % 16 == 0)
    launch("tpufg_yuv", q, q.data_ptr(), out.data_ptr(), h, w,
           int(chroma == "420"), vec, out=(out,))
    rgba_to_y4m_payload.launches += 1
    return out


rgba_to_y4m_payload.launches = 0


def payload_shape(out_h: int, out_w: int, chroma: str) -> tuple[int, int]:
    """Host-side shape of the payload array for (out_h, out_w)."""
    rows = 3 * out_h if chroma == "444" else out_h * 3 // 2
    return (rows, out_w)


def y4m_wire_ok(out_h: int, out_w: int, chroma: str) -> bool:
    """Whether the device payload path supports these dimensions."""
    if chroma == "444":
        return True
    return chroma == "420" and out_h % 4 == 0 and out_w % 2 == 0
