"""tpufg_torch box_downsample2 against tpufg's Pallas kernel (CPU,
interpret mode).  Tolerance: bitwise — both compute
0.5*(0.5*a + 0.5*c) + 0.5*(0.5*b + 0.5*d) with the same two roundings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.resize import box_downsample2 as jbox
from tpufg_torch.kernels.resize import box_downsample2, box_downsample2_plain


@pytest.mark.parametrize("shape", [(4, 64, 128), (3, 34, 60)])
@pytest.mark.parametrize("content", ["uniform", "codes"])
def test_box_downsample2_bitwise(shape, content):
    rng = np.random.default_rng(0)
    if content == "uniform":
        x = rng.random(shape, dtype=np.float32)
    else:  # dequantized UNORM8 frames, the pyramid's real input
        x = (rng.integers(0, 256, shape).astype(np.float32)
             * np.float32(1 / 255))
    ref = np.asarray(jbox(jnp.asarray(x)))
    out = box_downsample2(torch.from_numpy(x)).numpy()
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    plain = box_downsample2_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), out.view(np.int32))


def test_odd_dims_rejected():
    with pytest.raises(ValueError):
        box_downsample2(torch.zeros((4, 33, 64)))
