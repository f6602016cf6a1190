"""The gate arithmetic of RAFT's SepConvGRU (``core/update.py``), for
``models/raft.py``: per half of the GRU the published code runs ``z =
sigmoid(convz(hx))``, ``r = sigmoid(convr(hx))``, ``q = tanh(convq(cat(r
h, x)))``, ``h = (1 - z) h + z q``.  The model runs the ``z`` and ``r``
convs as one conv of 256 outputs (``z`` first) and both convs without
their bias; the bias adds, the f32 copies, the sigmoids and the tanh, the
products and the sum, and the bf16 copies into the next conv's input are
two passes:

- ``gru_gates``: ``r h``, rounded to bf16, into ``out`` (channels 0-127 of
  the 384-channel ``[h, inp, motion]`` input of the ``q`` conv);
- ``gru_update``: ``h = (1 - z) h + z q`` in f32, in place, and ``h``
  rounded to bf16 into ``out`` (the next conv's input) and, where given,
  into ``copy`` (the flow head's input).

Each gate is ``sigmoid(q(q(y) + b))`` (tanh for ``q``): the bf16 conv
output plus its bf16 bias rounded to bf16, as PyTorch's bias add rounds
it.  The plain versions are those PyTorch ops, one rounding each, which
CPU tensors take; ``csrc/raft_gru.cu`` runs on the card, bitwise the plain
versions.  Tensors: ``zr`` bf16 channels-last [1, 256, h, w], ``q`` bf16
channels-last [1, 128, h, w], ``h`` f32 channels-last [1, 128, h, w],
``out`` a 128-channel slice of a channels-last bf16 tensor, ``copy`` bf16
channels-last [1, 128, h, w], the biases bf16 [256] and [128].
"""

from __future__ import annotations

import torch

from tpufg_torch.kernels.common import launch, use_plain
from tpufg_torch.kernels.prelu import _slice_ok

F32 = torch.float32
BF16 = torch.bfloat16
CL = torch.channels_last
HIDDEN = 128


def _gate(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return (y.float() + bias.float()[None, :, None, None]).to(BF16).float()


def gru_gates_plain(zr: torch.Tensor, bias_zr: torch.Tensor, h: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    r = torch.sigmoid(_gate(zr[:, HIDDEN:], bias_zr[HIDDEN:]))
    out.copy_(r * h)
    return out


def gru_update_plain(zr: torch.Tensor, bias_zr: torch.Tensor,
                     q: torch.Tensor, bias_q: torch.Tensor, h: torch.Tensor,
                     out: torch.Tensor,
                     copy: torch.Tensor | None = None) -> torch.Tensor:
    z = torch.sigmoid(_gate(zr[:, :HIDDEN], bias_zr[:HIDDEN]))
    qt = torch.tanh(_gate(q, bias_q))
    h.copy_((1 - z) * h + z * qt)
    out.copy_(h)
    if copy is not None:
        copy.copy_(h)
    return h


def _check(zr, bias_zr, h, out, q=None, bias_q=None, copy=None) -> int:
    _, _, hh, ww = h.shape
    want = [("zr", zr, BF16, 2 * HIDDEN), ("h", h, F32, HIDDEN)]
    if q is not None:
        want.append(("q", q, BF16, HIDDEN))
    if copy is not None:
        want.append(("copy", copy, BF16, HIDDEN))
    for name, t, dtype, c in want:
        if (t.dtype != dtype or t.shape != (1, c, hh, ww)
                or not t.is_contiguous(memory_format=CL)):
            raise ValueError(f"raft_gru: {name} must be channels-last "
                             f"{dtype} [1, {c}, {hh}, {ww}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t, c in (("bias_zr", bias_zr, 2 * HIDDEN),
                       ("bias_q", bias_q, HIDDEN)):
        if t is not None and (t.dtype != BF16 or t.shape != (c,)
                              or not t.is_contiguous()):
            raise ValueError(f"raft_gru: {name} must be bf16 [{c}]")
    if not _slice_ok(out, HIDDEN, (hh, ww)):
        raise ValueError("raft_gru: out must be a 16-byte aligned channel "
                         f"slice [1, {HIDDEN}, h, w] of a channels-last bf16 "
                         "tensor")
    return hh * ww


def gru_gates(zr: torch.Tensor, bias_zr: torch.Tensor, h: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``r h`` into ``out`` (see the module's docstring); ``out``
    returned."""
    if use_plain(zr):
        return gru_gates_plain(zr, bias_zr, h, out)
    n = _check(zr, bias_zr, h, out)
    launch("tpufg_raft_gru_gates", zr, zr.data_ptr(), bias_zr.data_ptr(),
           h.data_ptr(), n, out.data_ptr(), out.stride(3), out=(out,))
    gru_gates.launches += 1
    return out


def gru_update(zr: torch.Tensor, bias_zr: torch.Tensor, q: torch.Tensor,
               bias_q: torch.Tensor, h: torch.Tensor, out: torch.Tensor,
               copy: torch.Tensor | None = None) -> torch.Tensor:
    """``h = (1 - z) h + z q`` in place, and ``h`` in bf16 into ``out``
    (and ``copy``); ``h`` returned."""
    if use_plain(zr):
        return gru_update_plain(zr, bias_zr, q, bias_q, h, out, copy)
    n = _check(zr, bias_zr, h, out, q, bias_q, copy)
    launch("tpufg_raft_gru_update", zr, zr.data_ptr(), bias_zr.data_ptr(),
           q.data_ptr(), bias_q.data_ptr(), h.data_ptr(), n, out.data_ptr(),
           out.stride(3), None if copy is None else copy.data_ptr(),
           out=(h,))
    gru_update.launches += 1
    return h


gru_gates.launches = 0
gru_update.launches = 0
