"""The engine warp's blend options, the occlusion blend and the MC fallback,
against tpufg's (CPU), on each warp the engine runs them on: the per-pixel
(OBMC) warp and the block warps (fractional at blocks 16 and 8, whole
pixels at block 16).  Tolerances: within 1e-6 on [0, 1] with f32 warps
(XLA sums the channel and cell means and contracts the blends in its own
order, the port rounds once per operation in a fixed order); with bf16
warps the per-pixel warp's seam difference (2^-8, see
tests/test_torch_quality.py) passes through the options' slopes (8 for the
occlusion, up to 2 / 0.015 for the fallback's ratio): within 2^-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.kernels.warp_matmul import warp_blend_matmul as jwarp
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul
from tests.test_torch_quality import TYPES, _pair

# the blend options on each warp: (block, bilinear, integer offsets with
# u8_exact), as the engine calls them
OPTION_WARPS = {"obmc": (8, True, False), "block16": (16, False, False),
                "block8": (8, False, False), "block16-int": (16, False, True)}


OPTIONS = {"occ": (True, False), "fb": (False, True), "occ+fb": (True, True)}
# (warp, options, dtype, t): every warp with each option in f32 at t = 0.5,
# both options in bf16, and t = 0.25 on the fractional warps
CASES = ([(wp, o, "f32", 0.5) for wp in OPTION_WARPS for o in OPTIONS]
         + [(wp, "occ+fb", "bf16", 0.5) for wp in OPTION_WARPS]
         + [(wp, "occ+fb", dt, 0.25) for wp in ("obmc", "block8")
            for dt in ("f32", "bf16")])


@pytest.mark.parametrize("warp,options,dtype,t", CASES)
def test_blend_options_match_tpufg(warp, options, dtype, t):
    """The options on one warp (width 192 with tpufg's column pad for the
    per-pixel warp).  Measured: f32 within 7.5e-7, bf16 within 4.1e-3."""
    g, bilinear, integer = OPTION_WARPS[warp]
    occlusion, fallback = OPTIONS[options]
    h, w = 64, 192 if warp == "obmc" else 256
    p, c, mv = _pair(g + 7 * occlusion + 3 * fallback, h, w, g)
    if integer:
        mv = (np.round(mv / 2) * 2).astype(np.float32)
    jd, td = TYPES[dtype]
    kw = dict(factor=t, block=g, search_radius=16, bilinear=bilinear,
              occlusion=occlusion, mc_fallback=fallback,
              integer_offsets=integer, u8_exact=True)
    ref = np.asarray(jwarp(jnp.asarray(p), jnp.asarray(c), jnp.asarray(mv),
                           dtype=jd, **kw))
    got = warp_blend_matmul(torch.from_numpy(p), torch.from_numpy(c),
                            torch.from_numpy(mv), dtype=td, **kw).numpy()
    assert got.shape == ref.shape == p.shape
    assert np.abs(got - ref).max() <= (1e-6 if dtype == "f32" else 2.0 ** -7)
