"""tpufg_torch's exhaustive motion searches against tpufg's Pallas kernels
(CPU; tpufg's kernels in interpret mode, as its own tests run them).

Tolerance: bitwise MV fields.  Shapes are tpufg's own
(tests/test_motion_kernel.py): the tiled search at (24,40)/b4/r4 ...
(24,150)/b4/r2 with both box orders and 3 or 4 channels, the sites search
at (64,256)/r4 and (96,384)/r8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_frame
from tpufg.kernels import motion as jmotion
from tpufg_torch.kernels import motion

TILED_CASES = [((24, 40), (3, 2), 4, 4),
               ((16, 16), (0, 0), 4, 2),
               ((40, 24), (-2, 3), 8, 4),
               ((24, 150), (1, -1), 4, 2)]


def _pair(rng, h, w, sx, sy, n_ch, pad=8):
    """prev and curr = prev moved by (sx, sy), planar [n_ch, h, w]."""
    base = random_frame(rng, h + 2 * pad, w + 2 * pad).transpose(2, 0, 1)
    prev = base[:n_ch, pad:pad + h, pad:pad + w]
    curr = base[:n_ch, pad - sy:pad - sy + h, pad - sx:pad - sx + w]
    return np.ascontiguousarray(prev), np.ascontiguousarray(curr)


@pytest.mark.parametrize("hw,shift,b,r", TILED_CASES)
@pytest.mark.parametrize("exact_box", [True, False])
@pytest.mark.parametrize("n_ch", [3, 4])
def test_tiled_bitwise(rng, hw, shift, b, r, exact_box, n_ch):
    prev, curr = _pair(rng, *hw, *shift, n_ch)
    ref = np.asarray(jmotion.motion_search_tiled(
        jnp.asarray(prev), jnp.asarray(curr), block_size=b, search_radius=r,
        exact_box=exact_box))
    out = motion.motion_search_tiled(
        torch.from_numpy(prev), torch.from_numpy(curr), block_size=b,
        search_radius=r, exact_box=exact_box).numpy()
    assert out.shape == ref.shape == (2, *hw)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("hw,r", [((64, 256), 4), ((96, 384), 8)])
@pytest.mark.parametrize("n_ch", [3, 4])
def test_sites_bitwise(rng, hw, r, n_ch):
    h, w = hw
    prev = rng.random((n_ch, h, w)).astype(np.float32)
    curr = np.roll(prev, (3, -2), (1, 2))
    # unrelated content in a band, so some costs have no zero-cost winner
    curr[:, :16] = rng.random((n_ch, 16, w)).astype(np.float32)
    ref = np.asarray(jmotion.motion_search_sites(
        jnp.asarray(prev), jnp.asarray(curr), search_radius=r, dx_chunk=1))
    out = motion.motion_search_sites(torch.from_numpy(prev),
                                     torch.from_numpy(curr), search_radius=r,
                                     dx_chunk=1).numpy()
    assert out.shape == ref.shape == (2, h // 16, w)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    # the sites field is the separable per-pixel field at the site rows
    full = motion.motion_search_tiled_plain(
        torch.from_numpy(prev), torch.from_numpy(curr), 8, r,
        exact_box=False).numpy()
    np.testing.assert_array_equal(out, full[:, 8::16])


def test_constant_pair_tiebreak():
    # every candidate ties: strict < keeps the first, (-r, -r) (PARITY.md)
    const = torch.full((4, 32, 64), 0.3)
    tiled = motion.motion_search_tiled(const, const, block_size=4,
                                       search_radius=2)
    sites = motion.motion_search_sites(const, const, search_radius=2,
                                       dx_chunk=1)
    assert torch.unique(tiled).tolist() == [-2.0]
    assert torch.unique(sites).tolist() == [-2.0]


ERROR_CASES = [
    ("sites", (4, 64, 256), dict(block_size=4), "block_size=8"),
    ("sites", (4, 64, 256), dict(grid=8), "block_size=8"),
    ("sites", (4, 72, 256), {}, "divisible by grid"),
    ("sites", (4, 64, 256), dict(search_radius=8, dx_chunk=3), "dx_chunk"),
    ("tiled", (4, 32, 32), dict(search_radius=4, dx_chunk=2), "dx_chunk"),
]


@pytest.mark.parametrize("which,shape,kw,match", ERROR_CASES)
def test_value_errors_match_tpufg(which, shape, kw, match):
    name = f"motion_search_{which}"
    z = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        getattr(jmotion, name)(jnp.asarray(z), jnp.asarray(z), **kw)
    with pytest.raises(ValueError, match=match):
        getattr(motion, name)(torch.from_numpy(z), torch.from_numpy(z), **kw)


@pytest.mark.parametrize("r,n_ch", [(16, 4), (16, 3), (80, 4), (4, 4)])
def test_sites_tile_w_matches_tpufg(r, n_ch):
    assert motion.sites_tile_w(r, n_ch) == jmotion.sites_tile_w(r, n_ch)
