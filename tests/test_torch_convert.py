"""tpufg_torch.kernels.convert against tpufg.kernels.convert (CPU).

The same numpy inputs go through both packages.  Tolerance: bitwise, for
the unpack on both wires and for both egress packers.  On the CPU,
tpufg's frames_to_planar takes its plain branch (the Pallas unpack runs
only on a TPU) and the port's wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels import convert as jconv
from tpufg_torch.kernels import convert as tconv

SHAPES = [(64, 128), (72, 88)]


def _frame(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4),
                                                dtype=np.uint8)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("wire", ["u8", "i32"])
def test_frames_to_planar_bitwise(hw, wire):
    f = _frame(0, *hw)
    if wire == "i32":
        f = f.view(np.int32).reshape(hw)
    ref = np.asarray(jconv.frames_to_planar(jnp.asarray(f)))
    out = tconv.frames_to_planar(torch.from_numpy(f)).numpy()
    assert out.dtype == np.float32 and out.shape == (4, *hw)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_unpack_is_the_reciprocal_multiply():
    # every code: tpufg's compiled read is byte * fl(1/255), which differs
    # from a true divide for about half the codes
    codes = np.arange(256, dtype=np.uint8)
    f = np.repeat(codes, 4).reshape(16, 16, 4)
    out = tconv.frames_to_planar(torch.from_numpy(f)).numpy()[0].ravel()
    ref = np.asarray(jconv.frames_to_planar(jnp.asarray(f)))[0].ravel()
    np.testing.assert_array_equal(out, ref)
    mul = codes.astype(np.float32) * np.float32(1 / 255)
    div = codes.astype(np.float32) / np.float32(255)
    np.testing.assert_array_equal(out, mul)
    assert int((mul != div).sum()) == 126


def _planar(seed, h, w):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (4, h, w)).astype(np.float32)
    # exact code midpoints exercise round-half-to-even
    k = rng.integers(0, 255, (4, h, w)).astype(np.float32)
    mid = ((k + np.float32(0.5)) / np.float32(255)).astype(np.float32)
    return np.where(rng.random((4, h, w)) < 0.3, mid, x).astype(np.float32)


@pytest.mark.parametrize("hw", SHAPES)
def test_planar_to_frames_bitwise(hw):
    x = _planar(1, *hw)
    ref = np.asarray(jconv.planar_to_frames(jnp.asarray(x)))
    out = tconv.planar_to_frames(torch.from_numpy(x)).numpy()
    assert out.dtype == np.uint8 and out.shape == (*hw, 4)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", SHAPES)
def test_planar_to_i32_bitwise(hw):
    x = _planar(2, *hw)
    ref = np.asarray(jconv.planar_to_i32(jnp.asarray(x)))
    out = tconv.planar_to_i32(torch.from_numpy(x)).numpy()
    assert out.dtype == np.int32 and out.shape == hw
    np.testing.assert_array_equal(out, ref)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tconv.frames_to_planar(torch.zeros((8, 8), dtype=torch.int32,
                                           device="meta"))
