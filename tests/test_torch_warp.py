"""tpufg_torch's warp against tpufg's warp_blend_matmul (CPU).

Integer offsets: bitwise (for the blend, see test_blend_u8_exact_bitwise).
The TPU warp moves pixels with one-hot matmuls; the port gathers.  Two
value domains have to be reproduced around the move: the single (refine)
warp's centring round trip fl(fl(x - 0.5) + 0.5), and the blend's centred
integer codes with ``u8_exact``.  Fractional offsets: see
test_fractional_warp.  Widths 192 (not a multiple of 128, which tpufg pads
internally) and 256 are covered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.warp_matmul import warp_blend_matmul as jwarp
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul

WIDTHS = [192, 256]


def _codes(rng, shape):
    return (rng.integers(0, 256, shape).astype(np.float32)
            * np.float32(1 / 255))


def _box_mean(x):
    """One 2x2 box level of dequantized codes: the refine warp's input."""
    return (0.5 * (0.5 * x[:, 0::2, 0::2] + 0.5 * x[:, 1::2, 0::2])
            + 0.5 * (0.5 * x[:, 0::2, 1::2] + 0.5 * x[:, 1::2, 1::2])
            ).astype(np.float32)


@pytest.mark.parametrize("w", WIDTHS)
def test_single_integer_warp_bitwise(w):
    rng = np.random.default_rng(w)
    x = _box_mean(_codes(rng, (4, 128, 2 * w)))           # [4, 64, w]
    mv = rng.integers(-12, 13, (2, 4, w // 16)).astype(np.float32)
    ref = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(x), jnp.asarray(mv),
                           block=16, search_radius=10, single=True,
                           integer_offsets=True))
    out = warp_blend_matmul(torch.from_numpy(x), torch.from_numpy(x),
                            torch.from_numpy(mv), block=16, search_radius=10,
                            single=True, integer_offsets=True).numpy()
    assert out.shape == ref.shape == x.shape
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    # the centring round trip is not the identity on these values: a plain
    # gather of x would differ from the reference somewhere
    rt = ((x - np.float32(0.5)) + np.float32(0.5)).astype(np.float32)
    assert (rt != x).any()


def _oob_mask(md, scale, h, w):
    """interpolate.comp's blanking of one side, per pixel (numpy)."""
    o = np.repeat(np.repeat(md * scale, 16, axis=1), 16, axis=2)
    px = np.arange(w, dtype=np.float32)[None, :] + o[0]
    py = np.arange(h, dtype=np.float32)[:, None] + o[1]
    return ((px >= -0.5) & (px <= w - 0.5) & (py >= -0.5)
            & (py <= h - 0.5)).astype(np.float32)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_blend_u8_exact_bitwise(w, dtype):
    """The t=0.5 blend warps each side by -/+ mv/2 and returns
    wp*mask_p*0.5 + wc*mask_c*0.5.  Each side's warp is held bitwise to
    tpufg's single-mode warp with the same offsets, and the blend bitwise
    to tpufg's formula with one rounding per operation.  tpufg's compiled
    blend on the CPU lets XLA contract the final add into an FMA (one
    rounding fewer), so against it the port is exact wherever at most one
    side is in the frame and within 1 ulp where both are summed."""
    rng = np.random.default_rng(w + 1)
    h = 64
    p = _codes(rng, (4, h, w))
    c = _codes(rng, (4, h, w))
    # even MVs up to ±20: some exceed the ±16 clip, and edge blocks push
    # samples out of the frame (OOB mask)
    mv = 2.0 * rng.integers(-10, 11, (2, 4, w // 16)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(block=16, integer_offsets=True, u8_exact=True)
    out = warp_blend_matmul(torch.from_numpy(p), torch.from_numpy(c),
                            torch.from_numpy(-mv), factor=0.5,
                            search_radius=16, dtype=td, **kw).numpy()
    ref = np.asarray(jwarp(jnp.asarray(p), jnp.asarray(c), jnp.asarray(-mv),
                           factor=0.5, search_radius=16, dtype=jd, **kw))
    assert out.shape == ref.shape == p.shape

    md = np.clip(-mv, -16, 16)
    half = np.float32(0.5)
    sides = []
    for x, scale in ((p, -half), (c, half)):
        off = (md * scale).astype(np.float32)
        warped = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(x),
                                  jnp.asarray(off), single=True,
                                  search_radius=8, dtype=jd, **kw))
        mine = warp_blend_matmul(torch.from_numpy(x), torch.from_numpy(x),
                                 torch.from_numpy(off), single=True,
                                 search_radius=8, dtype=td, **kw).numpy()
        np.testing.assert_array_equal(mine.view(np.int32),
                                      warped.view(np.int32))
        sides.append((warped, _oob_mask(md, scale, h, w)))
    (wp, mp), (wc, mc) = sides
    expect = (wp * mp * half + wc * mc * half).astype(np.float32)
    np.testing.assert_array_equal(out.view(np.int32), expect.view(np.int32))

    ulp = np.abs(out.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    both = np.broadcast_to((mp > 0) & (mc > 0), ulp.shape)
    assert ulp.max() <= 1
    assert (ulp[~both] == 0).all()
    assert (mp == 0).any() and (mc == 0).any()  # the OOB mask engaged


# one ulp of each dtype at 1.0, the top of the [0, 1] value range
ULP_AT_ONE = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("t", [0.5, 0.25])
@pytest.mark.parametrize("single", [False, True])
def test_fractional_warp(w, dtype, t, single):
    """integer_offsets=False, the warp of exhaustive MVs and of t != 0.5.

    Blend mode warps integer MVs by -t and 1-t; single mode warps MVs that
    are multiples of t, so both move by multiples of t pixels.  At t = 0.5
    every lerp weight is 0, 1/2 or 1, every product is exact, and the port
    is bitwise equal to tpufg.  At t = 0.25 it is within one ulp of the
    dtype at 1.0: tpufg's compiled CPU warp contracts the f32 vertical lerp
    and the blend into FMAs (measured here: up to 16% of the f32 values
    differ, by at most 2^-23; under 0.3% in bf16, by at most 2^-9),
    while the port rounds once per operation as tpufg's source does."""
    rng = np.random.default_rng(w + int(t * 100) + 7 * single)
    h = 64
    p = _codes(rng, (4, h, w))
    c = _codes(rng, (4, h, w))
    mv = rng.integers(-20, 21, (2, h // 16, w // 16)).astype(np.float32)
    if single:
        mv = (mv * np.float32(t)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(factor=t, block=16, search_radius=16, single=single,
              integer_offsets=False, u8_exact=True)
    out = warp_blend_matmul(torch.from_numpy(p), torch.from_numpy(c),
                            torch.from_numpy(mv), dtype=td, **kw).numpy()
    ref = np.asarray(jwarp(jnp.asarray(p), jnp.asarray(c), jnp.asarray(mv),
                           dtype=jd, **kw))
    assert out.shape == ref.shape == p.shape
    if t == 0.5:
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    else:
        d = np.abs(out - ref)
        assert d.max() <= ULP_AT_ONE[dtype]
        assert (d > 0).mean() < (0.25 if dtype == "f32" else 0.01)
    # fractional offsets really ran: u8_exact does not round the values to
    # codes here, so some outputs fall between two codes
    codes = out * np.float32(255.0)
    assert (np.abs(codes - np.round(codes)) > 1e-3).any()


# option combinations tpufg refuses with a ValueError: (frame [C, H, W],
# kwargs); the MV lattice follows from the block
REFUSED_OPTIONS = [
    ((4, 32, 32), dict(integer_offsets=True, bilinear=True)),
    ((4, 32, 32), dict(block=4, bilinear=True)),        # block % 8
    ((4, 24, 36), dict(block=12, mc_fallback=True)),    # the pad's lattice
    ((4, 48, 48), dict(block=24, bilinear=True)),
    ((4, 32, 32), dict(occlusion=True, search_radius=200)),  # the reach
]


@pytest.mark.parametrize("shape,kwargs", REFUSED_OPTIONS)
def test_unported_warp_options_raise(shape, kwargs):
    """The per-pixel warp, the occlusion blend and the MC fallback are
    ported; what tpufg refuses of them (integer offsets with the per-pixel
    warp, a block that is not a multiple of 8 there, a block the 128-column
    pad cannot extend by whole blocks, a reach past the warp's window) the
    port refuses too."""
    g = kwargs.get("block", 16)
    x = np.zeros(shape, np.float32)
    mv = np.zeros((2, shape[1] // g, shape[2] // g), np.float32)
    with pytest.raises(ValueError):
        jwarp(jnp.asarray(x), jnp.asarray(x), jnp.asarray(mv), **kwargs)
    with pytest.raises(ValueError):
        warp_blend_matmul(torch.from_numpy(x), torch.from_numpy(x),
                          torch.from_numpy(mv), **kwargs)
