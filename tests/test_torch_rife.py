"""tpufg_torch's learned head (models/rife.py) against tpufg's (CPU).

Same seeded numpy inputs and weights through both packages; tpufg's Pallas
conv runs in interpret mode.  Tolerances:
- the loader, ``_down4_mean`` (16 taps summed row-major, as tpufg's CPU
  reduce_window sums them), ``_band_mat`` and the 8-px coarse warp:
  bitwise;
- ``_up2``: 1e-6 relative, at the borders too (PyTorch's bilinear lerp
  and XLA's resize einsum round their products and sums in different
  orders, and XLA's border weight 0.75 / 0.75 is not exactly 1);
- ``encode3`` and the trunk (``_head3_raw``, fed tpufg's own stream cache
  so the trunk alone is compared): the same math up to f32 sum order, but
  an intermediate that lands next to a bf16 rounding boundary rounds the
  other way and the next layers carry the step: encoder 5e-3, stage 1 1e-3
  and the refined output 5e-3 of max |reference| (measured here: at most
  2e-7, 7e-5 and 7e-4);
- ``tails_fast``: 2^-20 absolute on [0, 1] frames (the fractional warp's
  roundings follow tpufg's, see tests/test_torch_warp.py; XLA contracts
  the lattice sample and the fusion into FMAs), except at tpufg's window
  seam: its horizontal lerp adds the two 128-column halves of a 256-column
  window after rounding each to bf16, so an output whose two taps straddle
  the halves (column 111 - floor offset of each 128-column tile, offsets
  in [-8, 8]) rounds twice, 1 bf16 ulp (2^-9) of the centred value,
  which the bf16 vertical lerp can round once more: 2^-8 at most; the
  port rounds once.  UNORM8 codes within 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.models import rife as jrife
from tpufg.utils.checkpoint import save_pytree
from tpufg_torch.models import rife

CKPTS = ["head64.npz", "head64_v2.npz", "head64_v3.npz", "head64_v4.npz"]
V4 = "checkpoints/head64_v4.npz"


def _np(tree):
    return {k: {leaf: np.array(v, np.float32) for leaf, v in d.items()}
            for k, d in tree.items()}


def _torch(tree):
    return rife.params_to_torch(_np(tree), "cpu")


def _randomize(params, rng, names):
    """Random weights for layers tpufg's init zero-initialises (a zero
    c_head / r_head gives flow 0 everywhere and tests nothing)."""
    out = dict(params)
    for n in names:
        out[n] = {
            "w": jnp.asarray(rng.standard_normal(params[n]["w"].shape)
                             .astype(np.float32) * np.float32(0.05)),
            "b": jnp.asarray(rng.standard_normal(params[n]["b"].shape)
                             .astype(np.float32) * np.float32(0.5))}
    return out


def _heads():
    rng = np.random.default_rng(7)
    v3 = _randomize(jrife.init_params3(jax.random.PRNGKey(1)), rng,
                    ["c_head", "r_head"])
    v3c = _randomize(jrife.expand_v3_coarse_body2(
        jrife.init_params3(jax.random.PRNGKey(2))), rng,
        ["c_head", "r_head", "c_body2"])
    return {"v3": v3, "v3d": jrife.load_params(V4), "v3c": v3c}


def _codes(rng, shape):
    return (rng.integers(0, 256, shape) / 255).astype(np.float32)


@pytest.mark.parametrize("name", CKPTS)
def test_load_params_leaf_for_leaf(name):
    path = f"checkpoints/{name}"
    ref = jrife.load_params(path)
    got = rife.load_params(path)
    assert sorted(got) == sorted(ref)
    for layer in ref:
        for leaf in ("w", "b"):
            a, b = got[layer][leaf], np.asarray(ref[layer][leaf])
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for pred in ("is_v2", "is_v3", "has_stage2_diff", "has_coarse_body2"):
        assert getattr(rife, pred)(got) == getattr(jrife, pred)(ref), pred


def test_bundled_checkpoint_and_head_names():
    assert rife.bundled_checkpoint() == jrife.bundled_checkpoint()
    assert rife.bundled_checkpoint().endswith("head64_v4.npz")
    names = [rife.head_name(rife.load_params(f"checkpoints/{n}"))
             for n in CKPTS]
    assert names == ["v1", "v2", "v3", "v3d"]
    assert rife.head_name(_np(_heads()["v3c"])) == "v3c"


def test_load_params_v3c_and_refusals(tmp_path):
    v3c = jrife.expand_v3_coarse_body2(jrife.load_params(V4))
    save_pytree(str(tmp_path / "v3dc.npz"), v3c)
    got = rife.load_params(str(tmp_path / "v3dc.npz"))
    assert rife.head_name(got) == "v3dc"
    np.testing.assert_array_equal(got["c_body2"]["w"],
                                  np.asarray(v3c["c_body2"]["w"]))
    bad = dict(jrife.load_params(V4))
    bad["r_body"] = {"w": jnp.zeros((64, 60, 3, 3)), "b": jnp.zeros((64,))}
    save_pytree(str(tmp_path / "bad.npz"), bad)
    with pytest.raises(ValueError, match="r_body.w"):
        rife.load_params(str(tmp_path / "bad.npz"))
    with pytest.raises(NotImplementedError, match="v2"):
        q = (torch.zeros((4, 8, 8)), torch.zeros((32, 8, 8)))
        rife.trunk_fast(rife.load_params("checkpoints/head64_v2.npz"), q, q)


def test_down4_mean_bitwise():
    rng = np.random.default_rng(0)
    x = _codes(rng, (4, 64, 96)) + rng.normal(0, 1e-3, (4, 64, 96)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jrife._down4_mean)(jnp.asarray(x)[None]))[0]
    got = rife._down4_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_up2_matches_resize_at_the_borders():
    rng = np.random.default_rng(1)
    out = rng.normal(0, 3, (5, 6, 10)).astype(np.float32)
    ref = np.asarray(jax.jit(jrife._up2)(jnp.asarray(out)[None]))[0]
    got = rife._up2(torch.from_numpy(out)).numpy()
    assert got.shape == ref.shape == (5, 12, 20)
    scale = np.abs(ref).max()
    for edge in (got[:, 0] - ref[:, 0], got[:, -1] - ref[:, -1],
                 got[:, :, 0] - ref[:, :, 0], got[:, :, -1] - ref[:, :, -1]):
        assert np.abs(edge).max() <= 1e-6 * scale
    assert np.abs(got - ref).max() <= 1e-6 * scale
    # the corner copies its input: flows doubled, the mask logit not
    np.testing.assert_array_equal(got[:, 0, 0], out[:, 0, 0]
                                  * np.array([2, 2, 2, 2, 1], np.float32))


@pytest.mark.parametrize("n_out,n_in", [(48, 12), (80, 20), (2160, 540)])
def test_band_mat_bitwise(n_out, n_in):
    np.testing.assert_array_equal(rife._band_mat(n_out, n_in).numpy(),
                                  jrife._band_mat(n_out, n_in))


def test_coarse_warp8_quarter_not_multiple_of_8():
    """Frames 80 x 48: quarter frames 20 x 12, so rows, columns and the
    flow lattice are all edge-padded to the 8-px block grid and cropped;
    flows up to +-6 also exercise the warp's +-4 clamp."""
    rng = np.random.default_rng(2)
    p4 = _codes(rng, (4, 20, 12))
    c4 = _codes(rng, (4, 20, 12))
    out0_4 = rng.uniform(-6, 6, (5, 20, 12)).astype(np.float32)
    ref = jrife._coarse_warp8(jnp.asarray(out0_4)[None],
                              jnp.asarray(p4)[None], jnp.asarray(c4)[None],
                              jnp.bfloat16)
    got = rife._coarse_warp8(torch.from_numpy(out0_4), torch.from_numpy(p4),
                             torch.from_numpy(c4))
    for g, r in zip(got, ref):
        r = np.asarray(r)[0]
        assert g.shape == r.shape == (4, 20, 12)
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      r.view(np.int32))
    assert not np.array_equal(got[0].numpy(), p4)  # something moved


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", ["v3", "v3d", "v3c"])
def test_encode_and_trunk_match_tpufg(name):
    params = _heads()[name]
    tp = _torch(params)
    rng = np.random.default_rng(3)
    h, w = 80, 112   # quarter 20 x 28, eighth 10 x 14: off the 8-px grid
    prev = _codes(rng, (4, h, w))
    curr = np.roll(prev, (2, 3), (1, 2))
    jp, jc = jnp.asarray(prev)[None], jnp.asarray(curr)[None]
    cache = dict(p4=jrife._down4_mean(jp), c4=jrife._down4_mean(jc),
                 f4p=jrife.encode3(params, jp, jnp.bfloat16, fast=True),
                 f4c=jrife.encode3(params, jc, jnp.bfloat16, fast=True))
    f4p = rife.encode3(tp, torch.from_numpy(prev)).numpy()
    assert _rel(f4p, np.asarray(cache["f4p"])[0]) <= 5e-3
    ref1, ref0 = jrife._head3_raw(params, jp, jc, dtype=jnp.bfloat16,
                                  fast=True, **cache)
    got1, got0 = rife._head3_raw(
        tp, *(torch.from_numpy(np.array(cache[k])[0])
              for k in ("p4", "c4", "f4p", "f4c")))
    ref1, ref0 = np.asarray(ref1)[0], np.asarray(ref0)[0]
    assert got0.shape == ref0.shape == (5, h // 8, w // 8)
    assert got1.shape == ref1.shape == (5, h // 4, w // 4)
    assert _rel(got0.numpy(), ref0) <= 1e-3
    assert _rel(got1.numpy(), ref1) <= 5e-3
    assert np.abs(ref1[:4]).max() > 0.1  # the head predicts flows
    # trunk_fast on the port's own stream caches
    full = rife.trunk_fast(tp, rife.frame_cache(tp, torch.from_numpy(prev)),
                           rife.frame_cache(tp, torch.from_numpy(curr)))
    assert _rel(full.numpy(), ref1) <= 5e-3


@pytest.mark.parametrize("t", [0.5, 0.25])
@pytest.mark.parametrize("w", [80, 128])
def test_tails_fast_matches_tpufg(t, w):
    """Widths 80 (not a multiple of 128: tpufg edge-pads it for its matmul
    warp, the port's gather clamps instead) and 128."""
    rng = np.random.default_rng(int(t * 100) + w)
    h = 48
    prev, curr = _codes(rng, (4, h, w)), _codes(rng, (4, h, w))
    out = rng.normal(0, 1.0, (5, h // 4, w // 4)).astype(np.float32)
    params = jrife.load_params(V4)
    ref = np.asarray(jrife.tails_fast(
        params, jnp.asarray(out), jnp.asarray(prev), jnp.asarray(curr),
        [t])[0])
    got = rife.tails_fast(_torch(params), torch.from_numpy(out),
                          torch.from_numpy(prev), torch.from_numpy(curr),
                          [t])[0].numpy()
    assert got.shape == ref.shape == (4, h, w)
    d = np.abs(got - ref)
    seam = (np.arange(w) % 128 >= 103) & (np.arange(w) % 128 <= 119)
    assert d[:, :, ~seam].max() <= 2.0 ** -20
    assert d.max() <= 2.0 ** -8
    assert np.abs(np.round(got * 255) - np.round(ref * 255)).max() <= 1
    # the flows moved the frames: not a crossfade
    assert np.abs(got - (prev * (1 - t) + curr * t)).max() > 0.1
