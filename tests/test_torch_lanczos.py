"""tpufg_torch Lanczos against tpufg's Pallas kernels and f32 oracle (CPU).

The path has no learned weights; the state carried across is the pair of
per-axis tap tables, which must densify bitwise to tpufg's banded weight
blocks.  Output tolerances (PARITY.md): float output <= 2e-6 abs of
``lanczos_scale_fast`` in f32 and of the oracle; packed bytes within 1 code
of ``lanczos_scale_packed`` with <= 1e-3 of the bytes differing (f32) and
SSIM >= 0.999 (bf16, whose TPU form uses a split-bf16 dot; the port
computes in f32).  The port's ``lanczos_scale_fast`` ignores
``compute_dtype``: with bf16 it is bitwise its f32 output, within 2e-6 of
tpufg's f32 output and within 2^-15 of tpufg's own split-bf16 dot (whose
dropped low-by-low products and bf16-rounded residuals leave ~2^-16 of a
value; measured 1.0e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.common import pick_tile, round_up
from tpufg.kernels.lanczos import (_axis_plan, lanczos_scale_fast as jfast,
                                   lanczos_scale_packed as jpacked)
from tpufg.ops import lanczos_scale as oracle_scale
from tpufg.utils.quality import ssim
from tpufg_torch.kernels.lanczos import (axis_taps, lanczos_scale,
                                         lanczos_scale_fast,
                                         lanczos_scale_fast_plain,
                                         lanczos_scale_packed)

CASES = [((64, 128), (128, 256)), ((72, 88), (144, 176)),
         ((48, 80), (108, 180)), ((64, 128), (48, 96))]


def _codes(seed, c, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (c, h, w)).astype(np.float32)
            * np.float32(1 / 255))


def _dense_bands(in_size, out_size, a, tile_out, lane):
    """tpufg's banded blocks for one axis as one dense [in, out] matrix."""
    starts, bands, span, n_tiles, _, pad_left = _axis_plan(
        in_size, out_size, a, tile_out, lane)
    dense = np.zeros((in_size, out_size), np.float32)
    for t in range(n_tiles):
        lo, hi = t * tile_out, min(out_size, (t + 1) * tile_out)
        for r in range(span):
            c = int(starts[t]) + r - pad_left
            if 0 <= c < in_size:
                dense[c, lo:hi] = bands[t, r, :hi - lo]
    return dense


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_tap_tables_bitwise_equal_to_bands(in_hw, out_hw):
    # the tile/lane plans lanczos_scale_packed uses for x (128) and y (8)
    for (n_in, n_out), lane in ((( in_hw[1], out_hw[1]), 128),
                                ((in_hw[0], out_hw[0]), 8)):
        tile = pick_tile(n_out, lane, min(256, round_up(n_out, lane)))
        ref = _dense_bands(n_in, n_out, 3, tile, lane)
        idx, w = axis_taps(n_in, n_out, 3)
        assert idx.shape == w.shape == (n_out, 6)
        assert idx.min() >= 0 and idx.max() < n_in
        dense = np.zeros((n_in, n_out), np.float32)
        np.add.at(dense, (idx, np.broadcast_to(np.arange(n_out)[:, None],
                                               idx.shape)), w)
        np.testing.assert_array_equal(dense.view(np.int32),
                                      ref.view(np.int32))


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_float_output_matches_fast_kernel_and_oracle(in_hw, out_hw):
    x = _codes(0, 4, *in_hw)
    out = lanczos_scale(torch.from_numpy(x), *out_hw).numpy()
    fast = np.asarray(jfast(jnp.asarray(x), *out_hw,
                            compute_dtype=jnp.float32))
    hwc = jnp.transpose(jnp.asarray(x), (1, 2, 0))
    orc = np.transpose(np.asarray(oracle_scale(hwc, *out_hw)), (2, 0, 1))
    assert out.shape == fast.shape == orc.shape
    np.testing.assert_allclose(out, fast, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out, orc, rtol=0, atol=2e-6)


@pytest.mark.parametrize("in_hw,out_hw", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_bytes_match_tpufg(in_hw, out_hw, dtype):
    x = _codes(1, 4, *in_hw)
    cd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ref = np.asarray(jpacked(jnp.asarray(x), *out_hw, compute_dtype=cd))
    out = lanczos_scale_packed(torch.from_numpy(x), *out_hw).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape == (*out_hw, 4)
    d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    if dtype == "f32":
        assert (d > 0).mean() <= 1e-3
    else:
        assert ssim(out / 255.0, ref / 255.0) >= 0.999
    raw = lanczos_scale_packed(torch.from_numpy(x), *out_hw,
                               raw_i32=True).numpy()
    np.testing.assert_array_equal(raw.view(np.uint8).reshape(out.shape), out)


FAST_CASES = [(3, (32, 128), (64, 256)), (4, (64, 256), (48, 200))]


@pytest.mark.parametrize("c,in_hw,out_hw", FAST_CASES)
def test_fast_matches_tpufg_fast(c, in_hw, out_hw):
    x = _codes(2, c, *in_hw)
    xt = torch.from_numpy(x)
    out = lanczos_scale_fast(xt, *out_hw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (c, *out_hw)
    ref = np.asarray(jfast(jnp.asarray(x), *out_hw))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6)
    # compute_dtype=bf16 computes in f32 all the same
    out_bf = lanczos_scale_fast(xt, *out_hw, compute_dtype=torch.bfloat16)
    assert torch.equal(out_bf.view(torch.int32), out.view(torch.int32))
    ref_bf = np.asarray(jfast(jnp.asarray(x), *out_hw,
                              compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(out_bf.numpy(), ref_bf, rtol=0, atol=2.0 ** -15)


def test_fast_bf16_input_keeps_dtype_and_ssim():
    x = _codes(3, 4, 32, 128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = lanczos_scale_fast(xb, 64, 256)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (4, 64, 256)
    # the f32 resample of the widened input, rounded once to bf16
    want = lanczos_scale(xb.float(), 64, 256).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert torch.equal(lanczos_scale_fast_plain(xb, 64, 256).view(torch.int16),
                       want.view(torch.int16))
    ref = np.asarray(jfast(jnp.asarray(x), 64, 256))
    s = ssim(np.transpose(ref, (1, 2, 0)),
             np.transpose(out.float().numpy(), (1, 2, 0)))
    assert s >= 0.999, s


def test_fast_rejects_a_non_planar_input():
    with pytest.raises(ValueError, match=r"\[C, H, W\]"):
        lanczos_scale_fast(torch.zeros((32, 128)), 64, 256)


@pytest.mark.parametrize("dtype,a,out_hw,match", [
    (torch.float16, 3, (64, 256), "float32 or bfloat16"),
    (torch.float32, 5, (64, 256), "support a in"),
    (torch.float32, 3, (0, 256), "invalid output size")],
    ids=["f16", "a5", "out_h0"])
def test_fast_refuses_on_the_cpu_what_the_kernel_refuses(dtype, a, out_hw,
                                                         match):
    x = torch.zeros((4, 32, 128), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        lanczos_scale_fast(x, *out_hw, a=a)
