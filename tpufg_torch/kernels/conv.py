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

``conv3x3_s2`` (csrc/conv_s2_mma.cu in bf16, csrc/conv_s2.cu in f32) and
``conv3x3_chain`` (csrc/conv_chain_mma.cu in bf16, csrc/conv_chain.cu in
f32) are the kernels: the bf16 forms are implicit GEMMs on the tensor
cores, the f32 forms run on the CUDA cores.  Both take their weights packed
once per set of weight tensors (:func:`packed_weights`).  On a CPU tensor
each takes its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.nn.functional as F

from tpufg_torch.kernels.common import (check_kernel_input, launch,
                                        round_up, use_plain)

F32 = torch.float32
BF16 = torch.bfloat16

# the stride-2 kernels: input channels instantiated, output channels
# (padded)
_S2_CIN = (4, 8)
_S2_COUT = 32
# the chain kernels: layers per launch, the output tile (rows, cols) of
# csrc/conv_chain_mma.cu (bf16: 8 x 32 beside the resident weights of
# 17 -> 64 -> 64 -> 5) and of csrc/conv_chain.cu (f32: three layers of up
# to 64 channels fit), the bf16 kernel's widest layer, and the shared memory
# a block may use
_CHAIN_MAX_LAYERS = 3
_CHAIN_TILE = {BF16: (8, 32), F32: (16, 16)}
_CHAIN_MMA_MAX_CH = 64
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


def s2_gemm_weights(w: torch.Tensor) -> torch.Tensor:
    """The stride-2 conv's weights as the B matrix of csrc/conv_s2_mma.cu's
    implicit GEMM: bf16 [K, 32] with weight (co, ci, dy, dx) at row
    ``k = dy * Kpad + dx * Cin + ci``, column ``co``.  ``Kpad`` is a dy
    slice's 3 Cin values padded to a multiple of 16 (16 at Cin = 4, 32 at
    Cin = 8); the pad rows and the columns past Cout are zero."""
    cout, cin = w.shape[:2]
    kpad = round_up(3 * cin, 16)
    wk = torch.zeros((3, kpad, _S2_COUT), dtype=BF16, device=w.device)
    wk[:, :3 * cin, :cout] = (w.to(BF16).permute(2, 3, 1, 0)
                              .reshape(3, 3 * cin, cout))
    return wk.reshape(3 * kpad, _S2_COUT)


def pack_s2_weights_bf16(w: torch.Tensor, b: torch.Tensor):
    """csrc/conv_s2_mma.cu's operands: (:func:`s2_gemm_weights` in the
    fragment order of ``mma.m16n8k16``'s B operand, the f32 bias padded
    with zeros to 32).  The order is [k16 step][lane][n8 tile][register]
    [element], where lane = 4 g + t holds output channel 8 tile + g and GEMM
    rows 16 step + 8 register + 2 t + element: a lane reads a step's
    fragments of all four tiles as two 16-byte loads.
    :func:`unpack_s2_weights_bf16` is the inverse."""
    wk = s2_gemm_weights(w)
    steps = wk.shape[0] // 16
    # [step][register][t][element][tile][g] -> [step][g][t][tile][reg][elem]
    frag = wk.reshape(steps, 2, 4, 2, _S2_COUT // 8, 8).permute(0, 5, 2, 4,
                                                                1, 3)
    bp = torch.zeros((_S2_COUT,), dtype=F32, device=b.device)
    bp[:w.shape[0]] = b.to(F32)
    return frag.reshape(-1).contiguous(), bp


def unpack_s2_weights_bf16(wpack: torch.Tensor) -> torch.Tensor:
    """The [K, 32] matrix of :func:`s2_gemm_weights` back from
    :func:`pack_s2_weights_bf16`'s flat tensor."""
    steps = wpack.numel() // (16 * _S2_COUT)
    frag = wpack.reshape(steps, 8, 4, _S2_COUT // 8, 2, 2)
    return frag.permute(0, 4, 2, 5, 3, 1).reshape(16 * steps, _S2_COUT)


def _pack_s2_weights_f32(w: torch.Tensor, b: torch.Tensor):
    """csrc/conv_s2.cu's operands: [ci, dy, dx, co] rows of Cout padded
    with zeros to 32, and the padded f32 bias."""
    cout, cin = w.shape[:2]
    wt = torch.zeros((cin * 9, _S2_COUT), dtype=F32, device=w.device)
    wt[:, :cout] = w.to(F32).permute(1, 2, 3, 0).reshape(cin * 9, cout)
    bp = torch.zeros((_S2_COUT,), dtype=F32, device=b.device)
    bp[:cout] = b.to(F32)
    return wt, bp


def packed_s2_weights(w: torch.Tensor, b: torch.Tensor,
                      compute_dtype: torch.dtype,
                      device: torch.device | None = None):
    """The stride-2 kernels' weight operands for ``w``/``b`` on ``device``,
    packed once per pair of tensors (:func:`packed_weights`)."""
    pack = (pack_s2_weights_bf16 if compute_dtype == BF16
            else _pack_s2_weights_f32)
    return packed_weights(pack, (w, b), device)


def conv3x3_s2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """SAME 3x3 stride-2 conv with bias: planar [Cin, H, W] (H, W even)
    -> f32 [Cout, H/2, W/2], operands rounded to ``compute_dtype``, f32
    accumulation, the bias last; the relu stays with the caller.

    CUDA tensors run, in bf16, csrc/conv_s2_mma.cu (``mma.sync`` on the
    tensor cores) and, in f32, csrc/conv_s2.cu (CUDA cores), both for Cin 4
    or 8 and Cout up to 32, with the weights packed once per pair of weight
    tensors (:func:`packed_s2_weights`); CPU tensors take
    :func:`conv3x3_s2_plain`."""
    _check_s2(x)
    _check_dtype(compute_dtype)
    if use_plain(x):
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
    wt, bp = packed_s2_weights(w, b, compute_dtype, x.device)
    out = torch.empty((cout, h // 2, wd // 2), dtype=F32, device=x.device)
    launch("tpufg_conv_s2_bf16" if compute_dtype == BF16 else "tpufg_conv_s2",
           xc, xc.data_ptr(), wt.data_ptr(), bp.data_ptr(), out.data_ptr(),
           cin, cout, h, wd, out=(out,))
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


def chain_smem_layout(chans, tile: tuple[int, int]) -> tuple[int, int]:
    """(offset of the second buffer, total bytes) of one csrc/conv_chain.cu
    block (the f32 chain).  Layer i reads a planar f32 [C_i, th + 2(L-i),
    tw + 2(L-i)] region; even layers read buffer 0 (the input tile first),
    odd layers buffer 1, and the last layer writes to device memory."""
    n_layers = len(chans) - 1
    th, tw = tile
    sizes = [0, 0]
    for i in range(n_layers):
        halo = 2 * (n_layers - i)
        nbytes = chans[i] * (th + halo) * (tw + halo) * 4
        sizes[i % 2] = max(sizes[i % 2], round_up(nbytes, 16))
    return sizes[0], sizes[0] + sizes[1]


def _pow2_at_least(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def chain_mma_dims(chans) -> tuple[list[int], list[int]]:
    """Per layer of the bf16 chain (csrc/conv_chain_mma.cu): the k16 chunks
    of its input and the n8 tiles of its output.  Channels pad with zeros to
    a power of two: the input and every intermediate to at least 16 (one
    ``mma`` K step), the last layer's output to at least 8 (one N tile)."""
    n_layers = len(chans) - 1
    kcs, nts = [], []
    kc = _pow2_at_least(chans[0], 16) // 16
    for i in range(n_layers):
        n_pad = _pow2_at_least(chans[i + 1], 8 if i == n_layers - 1 else 16)
        kcs.append(kc)
        nts.append(n_pad // 8)
        kc = n_pad // 16
    return kcs, nts


def chain_mma_layout(chans, tile: tuple[int, int]) -> tuple[int, int, int]:
    """(offset of the second activation buffer, offset of the weights, total
    bytes) of one csrc/conv_chain_mma.cu block.  Every buffer is channels-
    last bf16 with one row pitch, tw + 2L pixels: the input tile holds
    th + 2L rows, layer i's output the th + 2(L-i) rows it is valid on;
    activations alternate between two buffers, and every layer's packed
    weights follow them."""
    n_layers = len(chans) - 1
    th, tw = tile
    kcs, nts = chain_mma_dims(chans)
    pitch = tw + 2 * n_layers
    sizes = [0, 0]
    for i in range(n_layers):
        rows = th + 2 * (n_layers - i)
        sizes[i % 2] = max(sizes[i % 2], rows * pitch * kcs[i] * 32)
    w_bytes = sum(9 * kc * nt * 256 for kc, nt in zip(kcs, nts))
    return sizes[0], sizes[0] + sizes[1], sizes[0] + sizes[1] + w_bytes


def pack_chain_weights_bf16(ws, bs) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 chain's weights in the order csrc/conv_chain_mma.cu reads
    them, and its biases.

    Returns (flat bf16 tensor, flat f32 tensor).  Layer after layer, the
    weights rounded to bf16 and zero-padded to [8 nt, 16 kc, 3, 3] lie in
    the fragment order of ``mma.m16n8k16``'s B operand: [tap][k16 chunk]
    [pair of n8 tiles][lane][tile of the pair][register][element], where
    lane = 4 g + t holds output channel 8 tile + g and input channels
    16 chunk + 8 register + 2 t + element (a single n8 tile has no pair
    axis).  A warp so loads the fragments of two tiles with one 16-byte
    load per lane.  Each bias is zero-padded to 8 nt values.  Runs on any
    device; :func:`unpack_chain_weights_bf16` is the inverse."""
    chans = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    kcs, nts = chain_mma_dims(chans)
    flat, bias = [], []
    for w, b, kc, nt in zip(ws, bs, kcs, nts):
        cout, cin = w.shape[:2]
        wp = torch.zeros((8 * nt, 16 * kc, 3, 3), dtype=BF16, device=w.device)
        wp[:cout, :cin] = w.to(BF16)
        q = min(nt, 2)
        # [tap][chunk][register][t][element][pair][tile of the pair][g]
        t = wp.permute(2, 3, 1, 0).reshape(9, kc, 2, 4, 2, nt // q, q, 8)
        flat.append(t.permute(0, 1, 5, 7, 3, 6, 2, 4).reshape(-1))
        bp = torch.zeros((8 * nt,), dtype=F32, device=b.device)
        bp[:cout] = b.to(F32)
        bias.append(bp)
    return torch.cat(flat), torch.cat(bias)


def unpack_chain_weights_bf16(wpack: torch.Tensor, chans) -> list:
    """The bf16 OIHW weights [C_{i+1}, C_i, 3, 3] of each layer back from
    :func:`pack_chain_weights_bf16`'s flat tensor."""
    kcs, nts = chain_mma_dims(chans)
    out, at = [], 0
    for i, (kc, nt) in enumerate(zip(kcs, nts)):
        n = 9 * kc * nt * 128
        q = min(nt, 2)
        t = wpack[at:at + n].reshape(9, kc, nt // q, 8, 4, q, 2, 2)
        wp = (t.permute(0, 1, 6, 4, 7, 2, 5, 3)
              .reshape(3, 3, 16 * kc, 8 * nt).permute(3, 2, 0, 1))
        out.append(wp[:chans[i + 1], :chans[i]].contiguous())
        at += n
    return out


def _pack_chain_weights_f32(ws, bs) -> tuple[list, list]:
    """csrc/conv_chain.cu's operands: per layer [tap, ci, co] f32 with Cout
    padded to 8, and the f32 bias."""
    wts, bias = [], []
    for w, b in zip(ws, bs):
        cout, cin = w.shape[:2]
        wt = torch.zeros((9, cin, round_up(cout, 8)), dtype=F32,
                         device=w.device)
        wt[:, :, :cout] = w.to(F32).permute(2, 3, 1, 0).reshape(9, cin, cout)
        wts.append(wt)
        bias.append(b.to(F32).contiguous())
    return wts, bias


# packed weights of the last few sets of weight tensors a kernel ran with:
# key -> (weak references to the tensors, packed operands)
_PACK_CACHE: dict = {}
_PACK_CACHE_SIZE = 8


def packed_weights(pack, args, device: torch.device | None = None):
    """``pack(*args)`` with every tensor moved to ``device`` (the first
    tensor's own by default), computed once per set of tensors.  ``args``
    holds tensors and sequences of tensors.  The same objects, unchanged
    since (same ``_version`` and storage), give the cached result back; an
    in-place update or a new tensor packs anew."""
    groups = [(a,) if isinstance(a, torch.Tensor) else tuple(a) for a in args]
    tensors = [t for g in groups for t in g]
    device = tensors[0].device if device is None else device
    key = (pack, device,
           tuple((id(t), t._version, t.data_ptr()) for t in tensors))
    hit = _PACK_CACHE.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    packed = pack(*(a.to(device) if isinstance(a, torch.Tensor)
                    else [t.to(device) for t in g]
                    for a, g in zip(args, groups)))
    while len(_PACK_CACHE) >= _PACK_CACHE_SIZE:
        _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
    _PACK_CACHE[key] = (tuple(weakref.ref(t) for t in tensors), packed)
    return packed


def packed_chain_weights(ws, bs, compute_dtype: torch.dtype,
                         device: torch.device | None = None):
    """The chain kernels' weight operands for ``ws``/``bs`` on ``device``
    (the weights' own by default), packed once per set of tensors
    (:func:`packed_weights`)."""
    pack = (pack_chain_weights_bf16 if compute_dtype == BF16
            else _pack_chain_weights_f32)
    return packed_weights(pack, (ws, bs), device)


def conv3x3_chain(x: torch.Tensor, ws, bs, relus=(True, True, False),
                  compute_dtype: torch.dtype = BF16) -> torch.Tensor:
    """A chain of SAME 3x3 stride-1 convs with bias and optional relu
    between layers, fused in one launch: [C0, H, W] -> f32 [CL, H, W].
    ``ws[i]`` [C_{i+1}, C_i, 3, 3], ``bs[i]`` [C_{i+1}].

    Each layer accumulates in f32, adds its bias, applies its relu, is set
    to zero outside the image (the next layer's SAME padding) and is
    rounded to ``compute_dtype`` before the next layer reads it; the last
    layer's f32 result is returned.  CUDA tensors run, in bf16,
    csrc/conv_chain_mma.cu (``mma.sync`` on the tensor cores, channels up
    to 64) and, in f32, csrc/conv_chain.cu (CUDA cores); both fuse up to 3
    layers, and the weights are packed once per set of weight tensors
    (:func:`packed_chain_weights`).  CPU tensors take
    :func:`conv3x3_chain_plain`."""
    chans = _check_chain(x, ws, bs, relus)
    _check_dtype(compute_dtype)
    if use_plain(x):
        return conv3x3_chain_plain(x, ws, bs, relus, compute_dtype)
    n_layers = len(ws)
    if n_layers > _CHAIN_MAX_LAYERS:
        raise ValueError(f"conv3x3_chain: the kernel fuses at most "
                         f"{_CHAIN_MAX_LAYERS} layers, got {n_layers}")
    _, h, wd = x.shape
    xc = x.to(F32).contiguous()
    check_kernel_input(xc, "conv3x3_chain", F32, 3)
    th, tw = _CHAIN_TILE[compute_dtype]
    if compute_dtype == BF16:
        if max(chans) > _CHAIN_MMA_MAX_CH:
            raise ValueError(f"conv3x3_chain: the bf16 kernel takes up to "
                             f"{_CHAIN_MMA_MAX_CH} channels, got {chans}")
        off, w_off, smem = chain_mma_layout(chans, (th, tw))
    else:
        off, smem = chain_smem_layout(chans, (th, tw))
    if smem > _MAX_SMEM:
        raise ValueError(f"conv3x3_chain: channels {chans} need {smem} bytes "
                         f"of shared memory per block (limit {_MAX_SMEM})")
    wts, bias = packed_chain_weights(ws, bs, compute_dtype, x.device)
    cs = (chans + [0] * _CHAIN_MAX_LAYERS)[:_CHAIN_MAX_LAYERS + 1]
    relu_mask = sum(1 << i for i, r in enumerate(relus) if r)
    out = torch.empty((chans[-1], h, wd), dtype=F32, device=x.device)
    if compute_dtype == BF16:
        launch("tpufg_conv_chain_bf16", xc, xc.data_ptr(), out.data_ptr(),
               wts.data_ptr(), bias.data_ptr(), n_layers, *cs, relu_mask, h,
               wd, th, tw, off, w_off, smem, out=(out,))
    else:
        ptrs = [0] * (2 * _CHAIN_MAX_LAYERS)
        ptrs[0:2 * n_layers:2] = [t.data_ptr() for t in wts]
        ptrs[1:2 * n_layers:2] = [t.data_ptr() for t in bias]
        launch("tpufg_conv_chain", xc, xc.data_ptr(), out.data_ptr(), *ptrs,
               n_layers, *cs, relu_mask, h, wd, th, tw, off, smem,
               out=(out,))
    conv3x3_chain.launches += 1
    return out


conv3x3_s2.launches = 0
conv3x3_chain.launches = 0
