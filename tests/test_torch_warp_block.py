"""tpufg_torch warp_blend_block against tpufg's Pallas kernel (CPU).

tpufg's kernel runs in interpret mode.  Tolerance: 1e-6 abs (measured
1.2e-7, one ulp of values in [0.5, 1)).  The port rounds once per
operation in tpufg's source order; XLA's CPU backend contracts the
bilinear lerps and the blend into FMAs (one rounding fewer), so a few
values differ in the last bit, never more.  Inputs are UNORM codes and
quarter-pel MVs made from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.warp import warp_blend_block as jwarp
from tpufg_torch.kernels.warp import warp_blend_block, warp_blend_block_plain

ATOL = 1e-6


def _codes(rng, c, h, w):
    return (rng.integers(0, 256, (c, h, w)).astype(np.float32)
            * np.float32(1 / 255))


def _quarter_pel(rng, lo, hi, shape):
    return (rng.integers(lo * 4, hi * 4 + 1, shape) / 4).astype(np.float32)


def _both(prev, curr, mv, **kw):
    ref = np.asarray(jwarp(jnp.asarray(prev), jnp.asarray(curr),
                           jnp.asarray(mv), **kw))
    out = warp_blend_block(torch.from_numpy(prev), torch.from_numpy(curr),
                           torch.from_numpy(mv), **kw)
    assert out.dtype == torch.float32
    return out.numpy(), ref


# (name, h, w, block, radius): the two small frame sizes
SIZES = {"32x128 b16 r16": (32, 128, 16, 16), "64x256 b8 r8": (64, 256, 8, 8)}
CASES = [
    # per-block quarter-pel MVs, every blend factor
    ("32x128 b16 r16", "blocks", 0.5, False),
    ("32x128 b16 r16", "blocks", 0.25, False),
    ("32x128 b16 r16", "blocks", 0.75, False),
    ("32x128 b16 r16", "blocks", 0.0, False),
    ("32x128 b16 r16", "blocks", 1.0, False),
    ("64x256 b8 r8", "blocks", 0.25, False),
    # one MV everywhere
    ("32x128 b16 r16", "uniform", 0.5, False),
    # +-r and beyond (clipped to r): the borders are blanked
    ("32x128 b16 r16", "edge", 0.5, False),
    ("64x256 b8 r8", "edge", 0.75, False),
    # the pure warp: prev at p + m, no mask
    ("32x128 b16 r16", "blocks", 0.5, True),
    ("64x256 b8 r8", "edge", 0.5, True),
]


@pytest.mark.parametrize("size,mvs,t,single", CASES,
                         ids=[f"{s}-{m}-t{t}-{'single' if sg else 'blend'}"
                              for s, m, t, sg in CASES])
def test_matches_tpufg(size, mvs, t, single):
    h, w, g, r = SIZES[size]
    rng = np.random.default_rng(h + int(t * 100) + 7 * single)
    prev, curr = _codes(rng, 4, h, w), _codes(rng, 4, h, w)
    shape = (2, h // g, w // g)
    if mvs == "blocks":
        mv = _quarter_pel(rng, -r, r, shape)
    elif mvs == "uniform":
        mv = np.broadcast_to(np.float32([3.25, -2.5])[:, None, None],
                             shape).copy()
    else:
        mv = rng.choice(np.float32([-r - 4, -r, r, r + 4]), shape)
    out, ref = _both(prev, curr, mv, factor=t, block=g, search_radius=r,
                     single=single)
    assert out.shape == ref.shape == (4, h, w)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    if mvs == "edge" and not single:
        # a blanked sample contributes 0, so some border pixels lose a tap
        assert (out[:, 0] < np.minimum(prev[:, 0], curr[:, 0]) - 1e-3).any() \
            or (out[:, -1] < np.minimum(prev[:, -1], curr[:, -1]) - 1e-3).any()


def test_three_channels_and_bf16_input_read_as_f32():
    rng = np.random.default_rng(5)
    prev, curr = _codes(rng, 3, 32, 128), _codes(rng, 3, 32, 128)
    mv = _quarter_pel(rng, -8, 8, (2, 2, 8))
    out, ref = _both(prev, curr, mv, factor=0.25)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    # UNORM codes are not bf16 values: read a bf16 input as its f32 widening
    pb = torch.from_numpy(prev).to(torch.bfloat16)
    cb = torch.from_numpy(curr).to(torch.bfloat16)
    got = warp_blend_block(pb, cb, torch.from_numpy(mv), factor=0.25)
    want = warp_blend_block_plain(pb.float(), cb.float(), torch.from_numpy(mv),
                                  factor=0.25)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_zero_motion_endpoints_are_the_frames():
    rng = np.random.default_rng(6)
    prev = torch.from_numpy(_codes(rng, 4, 32, 64))
    curr = torch.from_numpy(_codes(rng, 4, 32, 64))
    mv = torch.zeros((2, 2, 4))
    assert torch.equal(warp_blend_block(prev, curr, mv, factor=0.0), prev)
    assert torch.equal(warp_blend_block(prev, curr, mv, factor=1.0), curr)
    assert torch.equal(warp_blend_block(prev, curr, mv, single=True), prev)


def test_integer_single_warp_moves_pixels():
    rng = np.random.default_rng(8)
    prev = torch.from_numpy(_codes(rng, 4, 32, 128))
    mv = torch.full((2, 2, 8), 4.0)
    out = warp_blend_block(prev, prev, mv, single=True)
    # out[p] = prev[p + 4], edge-clamped past the frame
    assert torch.equal(out[:, :-4, :-4], prev[:, 4:, 4:])
    assert torch.equal(out[:, -1, -1], prev[:, -1, -1])


def test_rejects_bad_shapes():
    x = torch.zeros((4, 32, 120))
    with pytest.raises(ValueError, match="multiple of block"):
        warp_blend_block(x, x, torch.zeros((2, 2, 7)))
    x = torch.zeros((4, 32, 128))
    with pytest.raises(ValueError, match="mv must be"):
        warp_blend_block(x, x, torch.zeros((2, 4, 16)))
    with pytest.raises(ValueError, match="one"):
        warp_blend_block(x, x[:3], torch.zeros((2, 2, 8)))
