"""tpufg_torch.ops.oracle against tpufg's oracle as its exact step runs
it, under ``jax.jit`` (CPU).

The port follows the program XLA compiles, not the source text: constant
divisors become multiplies by their f32 reciprocals, products of
constants fold, and a multiply whose only use is an add fuses into an FMA
(the eager-form tests below pin each position).  Tolerances:
- bitwise everywhere, except
- the Lanczos scale at 4:3 and 3:4 ratios and at a = 2 (whose taps take
  sin(pi x / 2)): torch's CPU sine and XLA's differ in the last bit on some
  tap arguments; within 1e-6 abs, with at most 75% of the values differing
  (measured: 64% at 30x48 -> 40x64, 50% at a = 2), and bitwise once the
  port takes XLA's sine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.ops import oracle as jo
from tpufg_torch.ops import oracle as to

F32 = np.float32


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _frames(rng, h, w, n=2, c=4):
    return [rng.random((h, w, c), dtype=F32) for _ in range(n)]


SCALE_BITWISE = [
    ((24, 40), (48, 80)),     # 2x
    ((48, 80), (48, 80)),     # identity
    ((48, 80), (24, 40)),     # 1/2
]


@pytest.mark.parametrize("in_hw,out_hw", SCALE_BITWISE,
                         ids=["2x", "identity", "half"])
def test_lanczos_scale_bitwise(in_hw, out_hw):
    x = np.random.default_rng(0).random((*in_hw, 4), dtype=F32)
    ref = jax.jit(lambda v: jo.lanczos_scale(v, *out_hw))(x)
    out = to.lanczos_scale(*_t(x), *out_hw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("in_hw,out_hw,a", [((30, 48), (40, 64), 3),
                                            ((40, 64), (30, 48), 3),
                                            ((24, 40), (48, 80), 2)],
                         ids=["4:3", "3:4", "2x_a2"])
def test_lanczos_scale_sine_ratios(in_hw, out_hw, a, monkeypatch):
    x = np.random.default_rng(1).random((*in_hw, 4), dtype=F32)
    ref = np.asarray(jax.jit(lambda v: jo.lanczos_scale(v, *out_hw, a))(x))
    out = to.lanczos_scale(*_t(x), *out_hw, a).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    assert 0 < (out != ref).mean() <= 0.75
    # the difference is the sine's alone
    jsin = jax.jit(jnp.sin)
    monkeypatch.setattr(to.torch, "sin", lambda v: torch.from_numpy(
        np.array(jsin(v.numpy()))))
    to.axis_tables.cache_clear()
    try:
        np.testing.assert_array_equal(
            to.lanczos_scale(*_t(x), *out_hw, a).numpy(), ref)
    finally:
        to.axis_tables.cache_clear()


@pytest.mark.parametrize("n_in,n_out", [(40, 80), (1920, 1920), (27, 21),
                                        (35, 45), (1280, 1920), (62, 20)])
def test_axis_taps_bitwise(n_in, n_out):
    ref = jax.jit(jo._axis_taps, static_argnums=(0, 1, 2))(n_in, n_out, 3)
    out = to._axis_taps(n_in, n_out, 3)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_reciprocal_positions():
    """``/ 255`` and ``/ out`` compile into multiplies by f32 reciprocals:
    the port's forms equal the jitted ones, and a true divide does not."""
    codes = np.arange(256, dtype=np.uint8)
    deq = to.dequantize_unorm8(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jax.jit(jo.dequantize_unorm8)(codes)))
    assert (deq != codes.astype(F32) / F32(255)).sum() == 126
    # the tap position folds 1/out and in into one constant, which here
    # differs from in / out
    idx = np.arange(20, dtype=F32) + F32(0.5)
    folded = F32(F32(1) / F32(20)) * F32(62)
    assert folded != F32(62) / F32(20)
    pos = to._axis_taps(62, 20, 3)[1].numpy()
    ref = np.asarray(jax.jit(jo._axis_taps, static_argnums=(0, 1, 2))(
        62, 20, 3)[1])
    np.testing.assert_array_equal(pos, ref)
    frac = (idx.astype(np.float64) * folded - 0.5).astype(F32)
    frac = frac - np.floor(frac)
    np.testing.assert_array_equal(pos[:, 0], (F32(0) - frac) - F32(2))


def _two_roundings(a, b, c):
    b = b if isinstance(b, (int, float)) else b.to(torch.float32)
    return a * b + c


def test_fma_positions(monkeypatch):
    """The FMAs are where XLA fused them: the Lanczos accumulation, the
    positions, the lerps and the blend differ in the last bit when each
    product is rounded alone; the MV's uv step is fused only where prev's
    and curr's steps are distinct products (not at t = 0.5)."""
    rng = np.random.default_rng(2)
    x = rng.random((24, 40, 4), dtype=F32)
    p, c = _frames(rng, 24, 40)
    mv = (rng.standard_normal((24, 40, 2)) * 6).astype(F32)
    ref_s = np.asarray(jax.jit(lambda v: jo.lanczos_scale(v, 48, 80))(x))
    ref_w = np.asarray(jax.jit(lambda a, b, m: jo.warp_blend(a, b, m, 0.25))(
        p, c, mv))
    np.testing.assert_array_equal(
        to.lanczos_scale(*_t(x), 48, 80).numpy(), ref_s)
    np.testing.assert_array_equal(
        to.warp_blend(*_t(p, c, mv), 0.25).numpy(), ref_w)
    tb = to.warp_tables(24, 40, 0.5)
    assert not tb.fuse_x and not tb.fuse_y
    tb = to.warp_tables(24, 40, 0.25)
    assert tb.fuse_x and tb.fuse_y
    monkeypatch.setattr(to, "_fma", _two_roundings)
    to.axis_tables.cache_clear()
    to.warp_tables.cache_clear()
    try:
        assert (to.lanczos_scale(*_t(x), 48, 80).numpy() != ref_s).sum() > 0
        assert (to.warp_blend(*_t(p, c, mv), 0.25).numpy()
                != ref_w).sum() > 0
    finally:
        to.axis_tables.cache_clear()
        to.warp_tables.cache_clear()


WARPS = [(24, 40, 0.5), (24, 40, 0.25), (27, 45, 1 / 3), (32, 32, 0.75)]


@pytest.mark.parametrize("h,w,t", WARPS)
@pytest.mark.parametrize("kind", ["per_pixel", "crossfade", "coarse"])
def test_warp_blend_bitwise(h, w, t, kind):
    rng = np.random.default_rng(3)
    p, c = _frames(rng, h, w)
    if kind == "crossfade":
        ref = jax.jit(lambda a, b: jo.warp_blend(a, b, None, t))(p, c)
        out = to.warp_blend(*_t(p, c), None, t)
    else:
        mh, mw = (h, w) if kind == "per_pixel" else (h // 3, w // 5)
        mv = (rng.standard_normal((mh, mw, 2)) * 6).astype(F32)
        ref = jax.jit(lambda a, b, m: jo.warp_blend(a, b, m, t))(p, c, mv)
        out = to.warp_blend(*_t(p, c, mv), t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bilinear_sample_bitwise():
    rng = np.random.default_rng(4)
    img = rng.random((9, 11, 3), dtype=F32)
    u = rng.random((5, 7), dtype=F32) * F32(1.2) - F32(0.1)
    v = rng.random((5, 7), dtype=F32) * F32(1.2) - F32(0.1)
    np.testing.assert_array_equal(
        to.bilinear_sample(*_t(img, u, v)).numpy(),
        np.asarray(jax.jit(jo.bilinear_sample)(img, u, v)))


def test_unorm8_bitwise():
    """Every code's round trip, the .5 ties (round to even) and the
    clamps."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.random(1000, dtype=F32) * F32(1.4) - F32(0.2),
                        (np.arange(256, dtype=F32) + F32(0.5)) / F32(255),
                        np.arange(256, dtype=F32) / F32(255),
                        np.array([-1, 0, 1, 2], F32)])
    q = to.quantize_unorm8(*_t(x)).numpy()
    np.testing.assert_array_equal(
        q, np.asarray(jax.jit(jo.quantize_unorm8)(x)))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        to.quantize_unorm8(to.dequantize_unorm8(*_t(codes))).numpy(), codes)


@pytest.mark.parametrize("h,w,b,r", [(24, 40, 4, 2), (20, 36, 8, 4)])
def test_motion_search_bitwise(h, w, b, r):
    p, c = _frames(np.random.default_rng(6), h, w)
    ref = jax.jit(lambda x, y: jo.motion_search(x, y, b, r))(p, c)
    out = to.motion_search(*_t(p, c), b, r)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_motion_search_constant_pair_takes_the_first_candidate():
    """A constant pair scores every candidate alike: the strict ``<``
    keeps the first, (-r, -r), as the shader does."""
    f = np.full((12, 16, 4), 0.25, F32)
    out = to.motion_search(*_t(f, f), 4, 2).numpy()
    assert (out == -2).all()
