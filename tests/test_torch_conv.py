"""tpufg_torch's learned-head convs against tpufg's (CPU).

tpufg's Pallas kernels run in interpret mode, as tests/test_conv_kernel.py
runs them.  Tolerances, relative to max |reference|:
- ``conv_same`` vs ``rife._conv`` (both plain f32 convs over operands
  rounded the same way): 1e-6, room for f32 re-association of the tap sums;
- the stride-2 conv vs tpufg's conv3x3_s2 kernel: 2e-6 in f32 and in bf16
  (the operands round identically, only the order of the f32 sums
  differs; measured here: at most 4e-7);
- the chain vs tpufg's lax chain (the function tpufg's engine runs): 1e-6;
  vs tpufg's conv3x3_chain kernel: tpufg's own bounds, 2e-5 in f32 and
  3e-2 in bf16 (its f32 sums are ordered otherwise, and an intermediate
  that lands next to a bf16 rounding boundary can round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpufg.kernels.conv import conv3x3_chain as jchain
from tpufg.kernels.conv import conv3x3_s2 as js2
from tpufg.models import rife as jrife
from tpufg_torch.kernels.conv import (conv3x3_chain, conv3x3_chain_plain,
                                      conv3x3_s2, conv_same, same_pads)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _layers(rng, chans, bias_shift=0.0):
    ws = [(rng.standard_normal((chans[i + 1], chans[i], 3, 3)) * 0.2)
          .astype(np.float32) for i in range(len(chans) - 1)]
    bs = [(rng.standard_normal((chans[i + 1],)) * 0.1 + bias_shift)
          .astype(np.float32) for i in range(len(chans) - 1)]
    return ws, bs


def _lax_chain(x, ws, bs, relus, dt):
    """tpufg's stage 2 as its engine runs it: one rife._conv per layer."""
    a = jnp.asarray(x)[None]
    for w, b, r in zip(ws, bs, relus):
        a = jrife._conv(a, jnp.asarray(w), jnp.asarray(b), 1, dt)
        if r:
            a = jax.nn.relu(a)
    return np.asarray(a[0])


def test_same_pads_follow_xla():
    assert same_pads(8, 2) == (0, 1)   # stride 2, even: nothing in front
    assert same_pads(7, 2) == (1, 1)
    assert same_pads(8, 1) == (1, 1)
    assert same_pads(1, 2) == (1, 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stride,hw", [(1, (24, 40)), (1, (17, 31)),
                                       (2, (24, 40)), (2, (17, 31))])
def test_conv_same_matches_rife_conv(dtype, stride, hw):
    rng = np.random.default_rng(stride * 100 + hw[0])
    x = rng.standard_normal((16, *hw)).astype(np.float32)
    (w,), (b,) = _layers(rng, [16, 12])
    jd, td = DTYPES[dtype]
    ref = jrife._conv(jnp.asarray(x)[None], jnp.asarray(w), jnp.asarray(b),
                      stride, jd)[0]
    got = conv_same(_t(x), _t(w), _t(b), stride, td)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-6


def test_stride2_same_padding_is_zero_one():
    """XLA pads a stride-2 SAME conv of an even size by (0, 1): output
    (0, 0) reads rows and columns 0..2.  PyTorch's padding=1 would read
    -1..1 and move every output by a pixel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, 20)).astype(np.float32)
    (w,), (b,) = _layers(rng, [4, 8])
    ref = np.asarray(jrife._conv(jnp.asarray(x)[None], jnp.asarray(w),
                                 jnp.asarray(b), 2, jnp.float32)[0])
    got = conv_same(_t(x), _t(w), _t(b), 2).numpy()
    by_hand = (np.einsum("oiyx,iyx->o", w, x[:, 0:3, 0:3]) + b)
    np.testing.assert_allclose(got[:, 0, 0], by_hand, rtol=1e-5, atol=1e-6)
    shifted = F.conv2d(_t(x)[None], _t(w), _t(b), stride=2, padding=1)[0]
    assert _rel(got, ref) <= 1e-6
    assert np.abs(shifted.numpy() - ref).max() > 0.1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cin,hw", [(4, (32, 128)), (8, (64, 256)),
                                    (4, (60, 140)), (8, (60, 140))])
def test_conv_s2_matches_tpufg_kernel(dtype, cin, hw):
    rng = np.random.default_rng(cin + hw[0])
    x = rng.random((cin, *hw), np.float32)
    (w,), (b,) = _layers(rng, [cin, 32])
    jd, td = DTYPES[dtype]
    ref = js2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
              compute_dtype=jd)
    before = conv3x3_s2.launches
    got = conv3x3_s2(_t(x), _t(w), _t(b), compute_dtype=td)
    assert conv3x3_s2.launches == before  # the CPU takes the plain version
    assert tuple(got.shape) == (32, hw[0] // 2, hw[1] // 2)
    assert _rel(got.numpy(), ref) <= 2e-6


def test_conv_s2_rejects_odd_size():
    with pytest.raises(ValueError, match="even"):
        conv3x3_s2(torch.zeros((4, 63, 128)), torch.zeros((32, 4, 3, 3)),
                   torch.zeros((32,)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chans,hw", [([13, 16, 16, 5], (40, 130)),
                                      ([17, 16, 16, 5], (30, 72))])
def test_chain_matches_tpufg(dtype, chans, hw):
    rng = np.random.default_rng(chans[0] + hw[0])
    ws, bs = _layers(rng, chans)
    relus = (True, True, False)
    x = rng.standard_normal((chans[0], *hw)).astype(np.float32)
    jd, td = DTYPES[dtype]
    before = conv3x3_chain.launches
    got = conv3x3_chain(_t(x), [_t(w) for w in ws], [_t(b) for b in bs],
                        relus, compute_dtype=td).numpy()
    assert conv3x3_chain.launches == before
    assert _rel(got, _lax_chain(x, ws, bs, relus, jd)) <= 1e-6
    kern = jchain(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                  tuple(map(jnp.asarray, bs)), relus, compute_dtype=jd,
                  tile=(16, 128))
    assert _rel(got, kern) <= (2e-5 if dtype == "f32" else 3e-2)


def test_chain_border_matches_unfused_zero_padding():
    """Large positive biases make relu(bias) leak across the image border
    unless each intermediate is zero-padded as its own SAME conv: the
    plain chain does that by construction; held to tpufg's lax chain and
    its kernel at the corner."""
    rng = np.random.default_rng(2)
    ws, bs = _layers(rng, [4, 6, 6, 3], bias_shift=2.0)
    relus = (True, True, False)
    x = rng.standard_normal((4, 24, 136)).astype(np.float32)
    got = conv3x3_chain_plain(_t(x), [_t(w) for w in ws],
                              [_t(b) for b in bs], relus,
                              compute_dtype=torch.float32).numpy()
    ref = _lax_chain(x, ws, bs, relus, jnp.float32)
    kern = np.asarray(jchain(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                             tuple(map(jnp.asarray, bs)), relus,
                             compute_dtype=jnp.float32, tile=(8, 128)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref)[:, :4, :4].max() <= 1e-6 * scale
    assert np.abs(got - kern)[:, :4, :4].max() <= 2e-5 * scale


def test_chain_rejects_mismatched_layers():
    x = torch.zeros((4, 8, 8))
    with pytest.raises(ValueError, match="after 4 channels"):
        conv3x3_chain(x, [torch.zeros((6, 5, 3, 3))], [torch.zeros((6,))],
                      (True,))
    with pytest.raises(ValueError, match="relu"):
        conv3x3_chain(x, [torch.zeros((6, 4, 3, 3))], [torch.zeros((6,))],
                      (True, False))
