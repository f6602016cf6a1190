"""tpufg_torch pyramid_motion_search against tpufg's (CPU; tpufg's box
kernel in interpret mode).  Tolerance: bitwise MV field, at the engine's
setting (levels=3, r=4 then r=2, finest refine skipped)."""

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


def test_unseeded_only():
    x = torch.zeros((4, 64, 64))
    with pytest.raises(NotImplementedError):
        pyramid_motion_search(x, x, seed=torch.zeros((2, 4, 4)), **KW)
