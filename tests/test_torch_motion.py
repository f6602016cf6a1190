"""tpufg_torch's XLA-op searches against tpufg's (CPU): the lattice search
and the per-pixel ``motion_search_xla``.

Tolerance: bitwise MV field.  The lattice port stacks all candidates and
takes the first minimum; the reference scans them with a strict-< update.
``motion_search_xla`` scans as the reference does.  Inputs: a textured
frame and a shifted, lightly perturbed copy (so the argmin is decided by
real costs, not by noise ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.motion_xla import motion_search_lattice as jlattice
from tpufg.kernels.motion_xla import motion_search_xla as jxla
from tpufg_torch.kernels.motion_xla import (motion_search_lattice,
                                            motion_search_xla)


def _pair(seed, c, h, w, shift):
    rng = np.random.default_rng(seed)
    prev = (rng.integers(0, 256, (c, h, w)).astype(np.float32)
            * np.float32(1 / 255))
    curr = np.roll(prev, shift, axis=(1, 2))
    noise = rng.integers(-3, 4, curr.shape).astype(np.float32)
    curr = np.clip(curr + noise * np.float32(1 / 255), 0, 1)
    return prev, curr.astype(np.float32)


@pytest.mark.parametrize("radius", [4, 2])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("bias", [0.0, 0.1])
def test_lattice_mv_bitwise(radius, channels, bias):
    prev, curr = _pair(radius * 10 + channels, channels, 64, 128, (1, -2))
    ref = np.asarray(jlattice(jnp.asarray(prev), jnp.asarray(curr),
                              search_radius=radius, bias=bias))
    out = motion_search_lattice(torch.from_numpy(prev),
                                torch.from_numpy(curr),
                                search_radius=radius, bias=bias).numpy()
    assert out.shape == ref.shape == (2, 4, 8)
    np.testing.assert_array_equal(out, ref)
    # the shift is found where it lies inside the radius
    if radius >= 2:
        assert (out[0] == 2).mean() > 0.9 and (out[1] == -1).mean() > 0.9


def test_lattice_rejects_radius_outside_cell():
    x = torch.zeros((3, 32, 32))
    with pytest.raises(ValueError):
        motion_search_lattice(x, x, search_radius=5)


@pytest.mark.parametrize("metric", ["euclidean", "ssd"])
@pytest.mark.parametrize("channels,block,radius", [(4, 8, 2), (3, 5, 2)])
def test_xla_search_mv_bitwise(metric, channels, block, radius):
    prev, curr = _pair(block * 10 + channels, channels, 32, 64, (1, -2))
    ref = np.asarray(jxla(jnp.asarray(prev), jnp.asarray(curr),
                          block_size=block, search_radius=radius,
                          metric=metric))
    out = motion_search_xla(torch.from_numpy(prev), torch.from_numpy(curr),
                            block_size=block, search_radius=radius,
                            metric=metric).numpy()
    assert out.shape == ref.shape == (2, 32, 64)
    np.testing.assert_array_equal(out, ref)
    # the shift is found away from the wrapped border
    inner = out[:, 8:-8, 8:-8]
    assert (inner[0] == 2).mean() > 0.9 and (inner[1] == -1).mean() > 0.9


def test_xla_search_rejects_an_unknown_metric():
    """The port used to refuse a metric it did not know; tpufg never did.
    Both now take any string other than "euclidean" as "ssd": the fields
    agree bitwise, and "sad" is "ssd" by another name."""
    prev, curr = _pair(7, 3, 32, 48, (-1, 2))
    ref = np.asarray(jxla(jnp.asarray(prev), jnp.asarray(curr),
                          block_size=6, search_radius=2, metric="sad"))
    tp, tc = torch.from_numpy(prev), torch.from_numpy(curr)
    out = motion_search_xla(tp, tc, block_size=6, search_radius=2,
                            metric="sad")
    assert out.shape == ref.shape == (2, 32, 48)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(out, motion_search_xla(tp, tc, block_size=6,
                                              search_radius=2, metric="ssd"))
