"""3x3 convolutions of the learned heads: XLA's SAME conv and the two
Pallas conv kernels.

Counterpart of ``tpufg/kernels/conv.py`` (``conv3x3_s2``, ``conv3x3_chain``)
and of ``tpufg/models/rife.py::_conv``.  Layout is planar: [C, H, W]
activations, OIHW weights [Cout, Cin, 3, 3], f32 results.

Every conv here computes what ``lax.conv_general_dilated(x.astype(dt),
w.astype(dt), padding="SAME", preferred_element_type=f32) + b`` does:

- operands rounded to the compute dtype ``dt`` (bf16 or f32), products and
  sums in f32, the bias added last, an f32 result (a PyTorch bf16 conv
  would return bf16: one rounding more);
- XLA's SAME padding: total ``max((ceil(n/s) - 1)*s + 3 - n, 0)``, the
  smaller half in front.  For stride 2 on an even size that is (0, 1), not
  PyTorch's ``padding=1``, which would move every output by a pixel.

``conv_same`` is a plain op (tpufg leaves ``lax.conv`` to XLA outside any
Pallas kernel), so cuDNN may compute it; it runs with cuDNN's TF32 off, as
an f32 conv on the card would otherwise keep ~10 mantissa bits.

``conv3x3_s2`` (csrc/conv_s2.cu) and ``conv3x3_chain`` (csrc/conv_chain.cu)
are the kernels.  On a CPU tensor each takes its plain version; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import check_kernel_input, launch, on_cpu

F32 = torch.float32
BF16 = torch.bfloat16

# csrc/conv_s2.cu: input channels instantiated, output channels (padded)
_S2_CIN = (4, 8)
_S2_COUT = 32
# csrc/conv_chain.cu: layers per launch, the output tile (rows, cols) of
# each activation dtype (three layers of up to 64 channels fit), and the
# shared memory a block may use
_CHAIN_MAX_LAYERS = 3
_CHAIN_TILE = {BF16: (16, 32), F32: (16, 16)}
_MAX_SMEM = 227 * 1024


def same_pads(n: int, stride: int, k: int = 3) -> tuple[int, int]:
    """XLA's SAME padding (before, after) of one axis of size ``n``."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (F32, BF16):
        raise ValueError(f"compute dtype must be f32 or bf16, got {dtype}")


@contextlib.contextmanager
def _no_tf32(x: torch.Tensor):
    """cuDNN's TF32 off around a CUDA conv (other flags untouched)."""
    if x.device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int = 1, dtype: torch.dtype = F32) -> torch.Tensor:
    """``rife._conv`` on one planar frame: [Cin, H, W] -> f32
    [Cout, ceil(H/s), ceil(W/s)], operands rounded to ``dtype``, the conv
    in f32, SAME padding as XLA pads it."""
    _check_dtype(dtype)
    _, h, wd = x.shape
    pt, pb = same_pads(h, stride)
    pl, pr = same_pads(wd, stride)
    xr = F.pad(x.to(dtype).to(F32)[None], (pl, pr, pt, pb))
    with _no_tf32(x):
        y = F.conv2d(xr, w.to(dtype).to(F32), stride=stride)[0]
    return y + b.to(F32)[:, None, None]


# ---------------------------------------------------------------- conv3x3_s2

def _check_s2(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"conv3x3_s2 takes [C, H, W], got {tuple(x.shape)}")
    _, h, wd = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"conv3x3_s2 needs even H, W; got {h}x{wd}")


def conv3x3_s2_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """Plain torch version of :func:`conv3x3_s2`."""
    _check_s2(x)
    return conv_same(x, w, b, 2, compute_dtype)


def conv3x3_s2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """SAME 3x3 stride-2 conv with bias: planar [Cin, H, W] (H, W even)
    -> f32 [Cout, H/2, W/2], operands rounded to ``compute_dtype``, f32
    accumulation, the bias last; the relu stays with the caller.

    CUDA tensors run csrc/conv_s2.cu (Cin 4 or 8, Cout up to 32); CPU
    tensors take :func:`conv3x3_s2_plain`."""
    _check_s2(x)
    _check_dtype(compute_dtype)
    if on_cpu(x):
        return conv3x3_s2_plain(x, w, b, compute_dtype)
    cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3_s2: weights {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit {cin} input channels")
    if cin not in _S2_CIN or cout > _S2_COUT:
        raise ValueError(f"conv3x3_s2: the kernel takes Cin in {_S2_CIN} and "
                         f"Cout <= {_S2_COUT}, got {cin} -> {cout}")
    xc = x.to(F32).contiguous()
    check_kernel_input(xc, "conv3x3_s2", F32, 3)
    # [ci, dy, dx, co] rows of Cout padded with zeros, rounded to the dtype
    wt = torch.zeros((cin * 9, _S2_COUT), dtype=F32, device=x.device)
    wt[:, :cout] = (w.to(compute_dtype).to(F32).permute(1, 2, 3, 0)
                    .reshape(cin * 9, cout))
    bp = torch.zeros((_S2_COUT,), dtype=F32, device=x.device)
    bp[:cout] = b.to(F32)
    out = torch.empty((cout, h // 2, wd // 2), dtype=F32, device=x.device)
    launch("tpufg_conv_s2", xc, xc.data_ptr(), wt.data_ptr(), bp.data_ptr(),
           out.data_ptr(), cin, cout, h, wd, int(compute_dtype == BF16))
    conv3x3_s2.launches += 1
    return out


# ------------------------------------------------------------- conv3x3_chain

def _check_chain(x: torch.Tensor, ws, bs, relus) -> list[int]:
    """The chain's channel counts [C0, C1, ..., CL]; raises on a mismatch."""
    if x.dim() != 3:
        raise ValueError(f"conv3x3_chain takes [C, H, W], got "
                         f"{tuple(x.shape)}")
    if not ws or len(bs) != len(ws) or len(relus) != len(ws):
        raise ValueError(f"conv3x3_chain: {len(ws)} weights, {len(bs)} "
                         f"biases, {len(relus)} relu flags")
    chans = [x.shape[0]]
    for w, b in zip(ws, bs):
        if tuple(w.shape) != (w.shape[0], chans[-1], 3, 3) or \
                tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"conv3x3_chain: layer weights {tuple(w.shape)} "
                             f"/ bias {tuple(b.shape)} after {chans[-1]} "
                             "channels")
        chans.append(w.shape[0])
    return chans


def conv3x3_chain_plain(x: torch.Tensor, ws, bs,
                        relus=(True, True, False),
                        compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """Plain torch version of :func:`conv3x3_chain`: one :func:`conv_same`
    per layer, each reading the previous layer's f32 output (relu'd where
    asked) rounded to ``compute_dtype`` and zero-padded, as tpufg's lax
    chain does."""
    _check_chain(x, ws, bs, relus)
    a = x
    for w, b, relu in zip(ws, bs, relus):
        a = conv_same(a, w, b, 1, compute_dtype)
        if relu:
            a = torch.relu(a)
    return a


def chain_smem_layout(chans, tile: tuple[int, int],
                      elem_bytes: int) -> tuple[int, int]:
    """(offset of the second buffer, total bytes) of one csrc/conv_chain.cu
    block.  Layer i reads a [C_i, th + 2(L-i), tw + 2(L-i)] region; even
    layers read buffer 0 (the input tile first), odd layers buffer 1, and
    the last layer writes to device memory."""
    n_layers = len(chans) - 1
    th, tw = tile
    sizes = [0, 0]
    for i in range(n_layers):
        halo = 2 * (n_layers - i)
        nbytes = chans[i] * (th + halo) * (tw + halo) * elem_bytes
        sizes[i % 2] = max(sizes[i % 2], -(-nbytes // 16) * 16)
    return sizes[0], sizes[0] + sizes[1]


def conv3x3_chain(x: torch.Tensor, ws, bs, relus=(True, True, False),
                  compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """A chain of SAME 3x3 stride-1 convs with bias and optional relu
    between layers, fused in one launch: [C0, H, W] -> f32 [CL, H, W].
    ``ws[i]`` [C_{i+1}, C_i, 3, 3], ``bs[i]`` [C_{i+1}].

    Each layer accumulates in f32, adds its bias, applies its relu, is set
    to zero outside the image (the next layer's SAME padding) and is
    rounded to ``compute_dtype`` before the next layer reads it; the last
    layer's f32 result is returned.  CUDA tensors run csrc/conv_chain.cu
    (up to 3 layers); CPU tensors take :func:`conv3x3_chain_plain`."""
    chans = _check_chain(x, ws, bs, relus)
    _check_dtype(compute_dtype)
    if on_cpu(x):
        return conv3x3_chain_plain(x, ws, bs, relus, compute_dtype)
    n_layers = len(ws)
    if n_layers > _CHAIN_MAX_LAYERS:
        raise ValueError(f"conv3x3_chain: the kernel fuses at most "
                         f"{_CHAIN_MAX_LAYERS} layers, got {n_layers}")
    _, h, wd = x.shape
    xc = x.to(F32).contiguous()
    check_kernel_input(xc, "conv3x3_chain", F32, 3)
    # per layer: [tap, ci, co] with Cout padded to 8, rounded to the dtype
    wts, bias = [], []
    for w, b in zip(ws, bs):
        cout, cin = w.shape[:2]
        wt = torch.zeros((9, cin, -(-cout // 8) * 8), dtype=F32,
                         device=x.device)
        wt[:, :, :cout] = (w.to(compute_dtype).to(F32).permute(2, 3, 1, 0)
                           .reshape(9, cin, cout))
        wts.append(wt)
        bias.append(b.to(F32).contiguous())
    th, tw = _CHAIN_TILE[compute_dtype]
    off, smem = chain_smem_layout(chans, (th, tw),
                                  2 if compute_dtype == BF16 else 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"conv3x3_chain: channels {chans} need {smem} bytes "
                         f"of shared memory per block (limit {_MAX_SMEM})")
    ptrs = [0] * (2 * _CHAIN_MAX_LAYERS)
    ptrs[0:2 * n_layers:2] = [t.data_ptr() for t in wts]
    ptrs[1:2 * n_layers:2] = [t.data_ptr() for t in bias]
    cs = (chans + [0] * _CHAIN_MAX_LAYERS)[:_CHAIN_MAX_LAYERS + 1]
    relu_mask = sum(1 << i for i, r in enumerate(relus) if r)
    out = torch.empty((chans[-1], h, wd), dtype=F32, device=x.device)
    launch("tpufg_conv_chain", xc, xc.data_ptr(), out.data_ptr(), *ptrs,
           n_layers, *cs, relu_mask, h, wd, th, tw, off, smem,
           int(compute_dtype == BF16))
    conv3x3_chain.launches += 1
    return out


conv3x3_s2.launches = 0
conv3x3_chain.launches = 0
