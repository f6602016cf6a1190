"""tpufg_torch pyramid_motion_search against tpufg's (CPU; tpufg's box and
tiled-search kernels in interpret mode).  Tolerance: bitwise MV field, at
the engine's setting (levels=3, r=4 then r=2, finest refine skipped)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.io.sources import SyntheticSource
from tpufg.models.pyramid import pyramid_motion_search as jpyramid
from tpufg_torch.models.pyramid import pyramid_motion_search

KW = dict(levels=3, base_radius=4, refine_radius=2, skip_finest_refine=1)


def _planar(frames_u8):
    return [(f.astype(np.float32) * np.float32(1 / 255)).transpose(2, 0, 1)
            .copy() for f in frames_u8]


def _both(p, c):
    ref = np.asarray(jpyramid(jnp.asarray(p), jnp.asarray(c), **KW))
    out = pyramid_motion_search(torch.from_numpy(p), torch.from_numpy(c),
                                **KW).numpy()
    return out, ref


def test_pan_recovers_known_shift():
    # pan at (4, 2) px/frame: backward flow curr[q] = prev[q + (4, 2)]
    p, c = _planar(SyntheticSource(256, 128, n_frames=2,
                                   velocity=(4.0, 2.0)))
    out, ref = _both(p, c)
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (2, 8, 16)
    inner = out[:, 1:-1, 1:-1]
    assert (inner[0] == 4).all() and (inner[1] == 2).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_random_frames_bitwise(seed):
    rng = np.random.default_rng(seed)
    p, c = _planar(rng.integers(0, 256, (2, 128, 256, 4), dtype=np.uint8))
    out, ref = _both(p, c)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("block_size,skip", [(12, 1), (16, 1), (12, 0)])
def test_tiled_fallback_bitwise(block_size, skip):
    # radii that leave the 16-px cell take the per-pixel tiled search at
    # the coarse level and at every refine level that runs
    rng = np.random.default_rng(block_size)
    base = _planar(rng.integers(0, 256, (1, 160, 320, 4), dtype=np.uint8))[0]
    p = np.ascontiguousarray(base[:, 16:144, 32:288])
    c = np.ascontiguousarray(base[:, 14:142, 36:292])   # c[q] = p[q + (4, -2)]
    kw = dict(KW, block_size=block_size, skip_finest_refine=skip)
    ref = np.asarray(jpyramid(jnp.asarray(p), jnp.asarray(c), **kw))
    out = pyramid_motion_search(torch.from_numpy(p), torch.from_numpy(c),
                                **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (2, 8, 16)
    inner = out[:, 2:-2, 2:-2]
    assert ((inner[0] == 4) & (inner[1] == -2)).mean() > 0.9


def test_unseeded_only():
    """The temporal seed was refused here until it was ported; now the
    seeded search (a zero seed: its warps still lerp, and the single warp's
    centred round trip is not always the identity) is bitwise tpufg's."""
    rng = np.random.default_rng(2)
    p, c = _planar(rng.integers(0, 256, (2, 64, 64, 4), dtype=np.uint8))
    seed = np.zeros((2, 4, 4), np.float32)
    ref = np.asarray(jpyramid(jnp.asarray(p), jnp.asarray(c),
                              seed=jnp.asarray(seed), **KW))
    out = pyramid_motion_search(torch.from_numpy(p), torch.from_numpy(c),
                                seed=torch.from_numpy(seed), **KW).numpy()
    np.testing.assert_array_equal(out, ref)
