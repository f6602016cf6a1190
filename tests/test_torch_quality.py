"""The quality preset's modules against tpufg's (CPU, tpufg's Pallas kernels
in interpret mode): the linear resize, the MV median filter, the sub-pel
refine and the per-pixel (OBMC) warp with the occlusion blend and the MC
fallback.  Tolerances (measured values in each test's docstring):

- ``resize_linear``: bitwise to ``jax.image.resize(..., "linear")`` at its
  three users' shapes (the MV upsample, the per-column offsets, the
  per-pixel mask and cell means);
- ``median_filter_mv``: bitwise (a median of nine values is one of them);
- ``subpel_refine``: the same integer steps at every site, the refined
  field within 1e-3 px (its cost sums run in torch's order, not XLA's);
- the per-pixel warp: bf16 bitwise away from tpufg's 128-column seam
  (where XLA rounds the horizontal sum twice, the port once), within
  2^-8 there; f32 within 2^-23 (XLA contracts the f32 lerps and blends
  into FMAs, the port rounds once per operation);
- the occlusion blend and the MC fallback: see
  tests/test_torch_quality_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.warp_matmul import warp_blend_matmul as jwarp
from tpufg.models.pyramid import median_filter_mv as jmedian
from tpufg.models.pyramid import subpel_refine as jsubpel
from tpufg_torch.kernels.resize import resize_linear
from tpufg_torch.kernels.warp_matmul import (obmc_offsets, warp_blend_matmul,
                                             warp_obmc, warp_obmc_plain)
from tpufg_torch.models.pyramid import median_filter_mv, subpel_refine

ULP_AT_ONE = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7}
TYPES = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x):
    return np.asarray(x).view(np.int32)


def _codes(rng, shape):
    return (rng.integers(0, 256, shape).astype(np.float32)
            * np.float32(1 / 255))


# (input shape, output shape, sum_axes): the users at 128 x 256 frames and
# at the 1080p path's lattice
RESIZE_CASES = [
    ((2, 8, 16), (2, 16, 32), (1,)),          # the MV upsample to 8 px
    ((2, 68, 120), (2, 136, 240), (1,)),
    ((16, 32), (16, 256), ()),                # per-column offsets
    ((136, 240), (136, 1920), ()),
    ((16, 32), (128, 256), ()),               # the per-pixel OOB mask
    ((1, 16, 32), (1, 128, 256), ()),         # the fallback's cell means
]


@pytest.mark.parametrize("shape,out,sum_axes", RESIZE_CASES)
def test_resize_linear_bitwise(shape, out, sum_axes):
    rng = np.random.default_rng(len(shape) + out[-1])
    x = (rng.normal(0, 6, shape)).astype(np.float32)
    x.reshape(-1)[:3] = -0.0
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, out, "linear"))(jnp.asarray(x)))
    got = resize_linear(torch.from_numpy(x), out, sum_axes=sum_axes).numpy()
    assert got.shape == ref.shape == out
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_median_filter_bitwise():
    rng = np.random.default_rng(5)
    mv = (rng.integers(-8, 9, (2, 8, 16)) * 0.5).astype(np.float32)
    mv[0, 2, 2] = mv[1, 0, 0] = -0.0
    mv[:, 3:5, 3:5] = 40.0                     # an outlier block
    ref = np.asarray(jmedian(jnp.asarray(mv)))
    got = median_filter_mv(torch.from_numpy(mv)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert (got[:, 3:5, 3:5] != 40.0).any()


def _sheared(h, w, seed):
    """A smooth textured frame and its horizontal shear: row y moves by
    1.5 + 3 y / h px (sub-pixel, varying across the lattice)."""
    rng = np.random.default_rng(seed)
    xs = np.arange(w + 16, dtype=np.float64)
    rows = []
    for _ in range(4):
        f = rng.uniform(0.05, 0.4, 3)
        rows.append(sum(np.sin(xs * f[i] + i) for i in range(3)))
    prev = np.zeros((4, h, w), np.float32)
    curr = np.zeros((4, h, w), np.float32)
    for c in range(4):
        tex = 0.5 + 0.15 * rows[c][None, :] * np.cos(
            np.arange(h)[:, None] * 0.2 + c)
        for y in range(h):
            s = 1.5 + 3.0 * y / h
            prev[c, y] = tex[y, 8:8 + w]
            curr[c, y] = np.interp(xs[8:8 + w] - s, xs, tex[y])
    return prev, curr


@pytest.mark.parametrize("motion", ["pan", "shear"])
def test_subpel_refine_matches_tpufg(motion):
    """The pan (3, 1) px and the shear from integer starting MVs: every
    site's refinement within 1e-3 px of tpufg's (measured: 3.4e-4 at most;
    the costs' sums run in another order), so no integer step differs (a
    different step moves a site by at least 0.5 px)."""
    h, w = 128, 256
    if motion == "pan":
        from tpufg.io.sources import SyntheticSource
        p, c = [(f.astype(np.float32) * np.float32(1 / 255))
                .transpose(2, 0, 1).copy()
                for f in SyntheticSource(w, h, n_frames=2,
                                         velocity=(3.0, 1.0))]
        mv = np.zeros((2, h // 16, w // 16), np.float32)
        mv[0], mv[1] = 2.0, 0.0
    else:
        p, c = _sheared(h, w, 3)
        mv = np.zeros((2, h // 16, w // 16), np.float32)
        mv[0] = -2.0
    ref = np.asarray(jsubpel(jnp.asarray(p), jnp.asarray(c), jnp.asarray(mv),
                             grid=16, search_radius=16, bias=0.1,
                             dtype=jnp.bfloat16))
    got = subpel_refine(torch.from_numpy(p), torch.from_numpy(c),
                        torch.from_numpy(mv), grid=16, search_radius=16,
                        bias=0.1, dtype=torch.bfloat16).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3
    assert (np.abs(ref - mv) > 0.01).mean() > 0.5     # the refine moved


def _seam(offs, h, w, g, halo):
    """Pixels one of whose bands' horizontal taps straddle a 128-column
    half of tpufg's 256-column window (the seam)."""
    y = np.arange(h)
    j = (y - g // 2) // g
    ja, jb = np.clip(j, 0, h // g - 1), np.clip(j + 1, 0, h // g - 1)
    x = np.arange(w)[None, :]
    seam = np.zeros((h, w), bool)
    for side in range(0, offs.shape[0], 2):
        ix0 = np.floor(offs[side]).astype(int)
        for jj in (ja, jb):
            seam |= (x + ix0[jj] + halo - x // 128 * 128) == 127
    return seam


def _pair(seed, h, w, g):
    rng = np.random.default_rng(seed)
    p, c = _codes(rng, (4, h, w)), _codes(rng, (4, h, w))
    mv = rng.uniform(-20, 20, (2, h // g, w // g)).astype(np.float32)
    return p, c, mv


@pytest.mark.parametrize("single", [True, False], ids=["single", "blend"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("w", [256, 192])
def test_obmc_warp_matches_tpufg(single, dtype, w):
    """The per-pixel warp (block 8, continuous MVs past the clip).  bf16:
    every differing value lies on tpufg's seam, within 2^-8 (measured: 0.2%
    of the values in single mode, 0.5% in blend mode); f32: within 2^-23
    (measured: ~9% of the values)."""
    h, g, r = 128, 8, 16
    p, c, mv = _pair(w + single, h, w, g)
    jd, td = TYPES[dtype]
    kw = dict(block=g, search_radius=r, single=single, bilinear=True)
    ref = np.asarray(jwarp(jnp.asarray(p), jnp.asarray(c), jnp.asarray(mv),
                           dtype=jd, **kw))
    got = warp_blend_matmul(torch.from_numpy(p), torch.from_numpy(c),
                            torch.from_numpy(mv), dtype=td, **kw).numpy()
    assert got.shape == ref.shape == p.shape
    d = np.abs(got - ref)
    if dtype == "f32":
        assert d.max() <= ULP_AT_ONE["f32"]
        assert (d > 0).mean() < 0.15
        return
    assert d.max() <= 2.0 ** -8
    assert (d > 0).mean() < 0.01
    # every difference on the seam (tpufg's column halo: 24 single, 16 in
    # the t = 0.5 blend; the offsets of both sides)
    wp = w if w % 128 == 0 else w + 128 - w % 128
    mvp = np.concatenate([mv, np.repeat(mv[:, :, -1:], (wp - w) // g, 2)],
                         axis=2)
    scales = (1.0,) if single else (-0.5, 0.5)
    offs = obmc_offsets(torch.from_numpy(mvp), r, scales, wp).numpy()
    seam = _seam(offs, h, wp, g, 24 if single else 16)[:, :w]
    assert not (d > 0)[:, ~seam].any()


@pytest.mark.parametrize("mode", ["single", "blend", "pair"])
def test_warp_obmc_wrapper_takes_the_plain_version_on_cpu(mode):
    p, c, mv = _pair(9, 64, 128, 8)
    kw = dict(block=8, search_radius=16, single=mode == "single",
              pair=mode == "pair", dtype=torch.bfloat16)
    before = warp_obmc.launches
    got = warp_obmc(torch.from_numpy(p), torch.from_numpy(c),
                    torch.from_numpy(mv), **kw)
    assert warp_obmc.launches == before
    ref = warp_obmc_plain(torch.from_numpy(p), torch.from_numpy(c),
                          torch.from_numpy(mv), **kw)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert tuple(got.shape) == ((10, 64, 128) if mode == "pair"
                                else (4, 64, 128))
