"""The tile walk both block warps run on Hopper (csrc/warp_tile.cuh),
emulated in plain torch on the CPU and held bitwise to the plain versions.

A "thread" owns a cell of V output columns x RT output rows inside one MV
block: its offset is split once, it loads V taps (integer offsets) or
V + 1 taps (fractional) of each tap row with every column and row clamped
to the frame, forms each tap row's horizontal sums once, and lerps
vertically between neighbouring tap rows, the RT + 1 rows of a cell
serving its RT output rows.  The arithmetic is each warp's policy (the
domain its values move in, the lerps, the rounding to bf16) with one
rounding per operation, as the .cu files write it.  Where V or RT does not
divide the block the walk falls back to V = RT = 1, as the launchers do.
The emulation is held bitwise to ``warp_blend_block_plain`` and
``warp_blend_matmul_plain`` over modes, types, block sizes, blend factors,
MVs past every edge and the engine's crop; the kernels themselves are held
to the plain versions in tests/test_torch_cuda.py and chip_smoke.py.
Also the wrapper's CPU dispatch.
"""

import numpy as np
import pytest
import torch

from tpufg_torch.kernels.warp import warp_blend_block, warp_blend_block_plain
from tpufg_torch.kernels.warp_matmul import (warp_blend_matmul,
                                             warp_blend_matmul_plain)

F32 = torch.float32
INV255 = 1.0 / 255.0


def _bits(x):
    return x.contiguous().view(torch.int32)


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32)
                            * np.float32(1 / 255))


class BlockPolicy:
    """csrc/warp_block.cu: f32 bilinear on the values as they are."""
    frac = True

    def weights(self, f):
        return 1.0 - f, f

    def load(self, x):
        return x

    def hlerp(self, a, b, w):
        return a * w[0] + b * w[1]

    def vlerp(self, t, b, w):
        return t * w[0] + b * w[1]

    def finish(self, o):
        return o


class MatmulPolicy:
    """csrc/warp_matmul.cu: the moving domain and type, the horizontal
    lerp an f32 sum rounded once, the vertical lerp in the type."""

    def __init__(self, frac, u8, bf16):
        self.frac, self.u8, self.bf16 = frac, u8, bf16

    def dt(self, x):
        return x.to(torch.bfloat16).to(F32) if self.bf16 else x

    def weights(self, f):
        b = self.dt(f)
        return self.dt(1.0 - b), b

    def load(self, x):
        if self.u8:
            return self.dt(torch.round(x * 255.0) - 128.0)
        return self.dt(x - 0.5)

    def hlerp(self, a, b, w):
        return self.dt(a * w[0] + b * w[1])

    def vlerp(self, t, b, w):
        return self.dt(self.dt(t * w[0]) + self.dt(b * w[1]))

    def finish(self, o):
        if self.u8:
            return (o + 128.0) * INV255
        return o + 0.5


def walk(policy, prev, curr, mv, g, r, t, single, v, rt, crop=None):
    """The warp by the cell walk of warp_tile.cuh, every cell at once."""
    n_ch, h, w = prev.shape
    oh, ow = crop or (h, w)
    if g % v or g % rt:
        v = rt = 1
    x0 = torch.arange(0, ow, v)[None, :]                  # [1, NX]
    y0 = torch.arange(0, oh, rt)[:, None]                 # [NY, 1]
    md = torch.clamp(mv.to(F32), -r, r)
    mdx, mdy = md[0][y0 // g, x0 // g], md[1][y0 // g, x0 // g]   # [NY, NX]
    t32 = float(np.float32(t))
    omt = float(np.float32(1.0) - np.float32(t))
    n_taps = v + 1 if policy.frac else v
    n_rows = rt + 1 if policy.frac else rt
    kk, jj = torch.arange(v), torch.arange(rt)

    def side(src, ox, oy, masked):
        fx, fy = torch.floor(ox), torch.floor(oy)
        wx, wy = policy.weights(ox - fx), policy.weights(oy - fy)
        cols = (x0 + fx.long())[..., None] + torch.arange(n_taps)
        rows = (y0 + fy.long())[..., None] + torch.arange(n_rows)
        cols, rows = cols.clamp(0, w - 1), rows.clamp(0, h - 1)
        # [C, NY, NX, rows, taps]: each tap row loaded once per cell
        taps = policy.load(src[:, rows[..., :, None], cols[..., None, :]])
        if policy.frac:
            ex = tuple(x[..., None, None] for x in wx)
            hs = policy.hlerp(taps[..., :-1], taps[..., 1:], ex)
            ey = tuple(x[..., None, None] for x in wy)
            o = policy.finish(policy.vlerp(hs[..., :-1, :], hs[..., 1:, :],
                                           ey))
        else:
            o = policy.finish(taps)                       # [C,NY,NX,RT,V]
        if not masked:
            return o, None

        def in_range(pos, off, size):
            p = pos.to(F32) + off
            return ((p >= -0.5) & (p <= size - 0.5)).to(F32)
        mx = in_range(x0[..., None] + kk, ox[..., None], w)   # [NY, NX, V]
        my = in_range(y0[..., None] + jj, oy[..., None], h)   # [NY, NX, RT]
        return o, my[..., :, None] * mx[..., None, :]

    if single:
        o, _ = side(prev, mdx, mdy, False)
    else:
        op, mp = side(prev, mdx * (-t32), mdy * (-t32), True)
        oc, mc = side(curr, mdx * omt, mdy * omt, True)
        o = op * mp * omt + oc * mc * t32
    ny, nx = o.shape[1:3]
    full = o.permute(0, 1, 3, 2, 4).reshape(n_ch, ny * rt, nx * v)
    return full[:, :oh, :ow]


# (V, RT): the defaults, the variants, and a cell of one pixel
CELLS = [(4, 2), (2, 1), (8, 2), (4, 4), (1, 1)]


def _push_out(mv, edge):
    """The border blocks' MVs point out of the frame by ``edge``: left and
    right columns along x, top and bottom rows along y (the blend moves
    its two sides opposite ways, so both sides leave every edge)."""
    mv[0, :, 0], mv[0, :, -1] = -edge, edge
    mv[1, 0, :], mv[1, -1, :] = -edge, edge
    return mv


def _frames(seed, c, h, w, g, r):
    """Code-valued prev/curr and quarter-pel MVs up to r + 6: past the
    clip, and at the borders past every edge of the frame."""
    rng = np.random.default_rng(seed)
    prev, curr = _codes(rng, (c, h, w)), _codes(rng, (c, h, w))
    mv = rng.integers(-4 * r - 24, 4 * r + 25, (2, h // g, w // g)) / 4
    return prev, curr, torch.from_numpy(_push_out(mv, r + 6).astype(
        np.float32))


@pytest.mark.parametrize("v,rt", CELLS)
@pytest.mark.parametrize("g,h,w", [(16, 32, 64), (8, 24, 40), (12, 36, 48),
                                   (10, 20, 30)])
@pytest.mark.parametrize("mode", [dict(t=0.5, single=False),
                                  dict(t=0.25, single=False),
                                  dict(t=0.5, single=True)],
                         ids=["t0.5", "t0.25", "single"])
def test_block_walk_bitwise(v, rt, g, h, w, mode):
    r = 6
    prev, curr, mv = _frames(g + v, 3, h, w, g, r)
    got = walk(BlockPolicy(), prev, curr, mv, g, float(r), mode["t"],
               mode["single"], v, rt)
    ref = warp_blend_block_plain(prev, curr, mv, factor=mode["t"], block=g,
                                 search_radius=r, single=mode["single"])
    assert torch.equal(_bits(got), _bits(ref))


# the engine's modes: (single, integer offsets, u8_exact)
MODES = {"blend-int-u8": (False, True, True),      # config 4's blend
         "blend-int": (False, True, False),
         "blend-frac": (False, False, True),       # config 3's (u8 unused)
         "single-int": (True, True, False),        # refine, coarse warp
         "single-frac": (True, False, False)}      # config 5's tail


def _matmul_case(mode, dtype, g, h, w, t, seed):
    single, integer, u8 = MODES[mode]
    r = 8
    rng = np.random.default_rng(seed)
    prev, curr = _codes(rng, (4, h, w)), _codes(rng, (4, h, w))
    lim = 2 * r + 6
    if integer:
        # whole-pixel moves: even MVs (halved at t = 0.5), any in single
        mv = rng.integers(-lim, lim + 1, (2, h // g, w // g))
        mv = mv * (1 if single else 2)
    else:
        # continuous offsets: the fractions round to bf16 (as the learned
        # tail's flows do), not only the quarter pels bf16 holds exactly
        mv = rng.uniform(-lim, lim, (2, h // g, w // g))
    mv = torch.from_numpy(_push_out(mv, lim).astype(np.float32))
    kw = dict(factor=t, block=g, search_radius=r, single=single, dtype=dtype,
              integer_offsets=integer, u8_exact=u8)
    return prev, curr, mv, r, kw, MatmulPolicy(not integer, u8 and integer,
                                               dtype == torch.bfloat16)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g,h,w", [(16, 48, 64), (8, 24, 56), (12, 36, 60)])
def test_matmul_walk_bitwise(mode, dtype, g, h, w):
    t = 0.5
    prev, curr, mv, r, kw, pol = _matmul_case(mode, dtype, g, h, w, t, g)
    ref = warp_blend_matmul_plain(prev, curr, mv, **kw)
    for v, rt in CELLS:
        got = walk(pol, prev, curr, mv, g, float(r), t, kw["single"], v, rt)
        assert torch.equal(_bits(got), _bits(ref)), (v, rt)


@pytest.mark.parametrize("mode", ["blend-frac", "single-frac"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [0.25, 0.7])
def test_matmul_walk_other_factors(mode, dtype, t):
    g, h, w = 16, 32, 64
    prev, curr, mv, r, kw, pol = _matmul_case(mode, dtype, g, h, w, t, 5)
    ref = warp_blend_matmul_plain(prev, curr, mv, **kw)
    got = walk(pol, prev, curr, mv, g, float(r), t, kw["single"], 4, 2)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("g,h,w,crop", [
    (16, 48, 64, (40, 64)),      # the engine's 1080 of 1088 rows
    (16, 32, 64, (29, 61)),      # a ragged window: partial cells
    (6, 18, 42, (18, 42)),       # a width V = 4 does not divide: V = 1
    (10, 20, 50, (17, 47))])
def test_matmul_walk_crops_and_ragged_widths(mode, g, h, w, crop):
    prev, curr, mv, r, kw, pol = _matmul_case(mode, torch.bfloat16, g, h, w,
                                              0.5, w)
    ref = warp_blend_matmul_plain(prev, curr, mv, crop=crop, **kw)
    got = walk(pol, prev, curr, mv, g, float(r), 0.5, kw["single"], 4, 2,
               crop)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("mode", ["single-int", "blend-frac"])
def test_walk_moves_past_every_edge(mode):
    """The cases above take taps from outside the frame on all four sides,
    past the clip, and the blend's masks blank some samples and keep
    others."""
    g, h, w = 16, 32, 64
    prev, curr, mv, r, kw, _ = _matmul_case(mode, F32, g, h, w, 0.5, g)
    assert bool((mv.abs() > r).any())
    md = torch.clamp(mv, -r, r) * (1.0 if kw["single"] else 0.5)
    assert float(md[0, :, 0].max()) < 0 < float(md[0, :, -1].min())
    assert float(md[1, 0].max()) < 0 < float(md[1, -1].min())
    if not kw["single"]:
        blend = warp_blend_matmul_plain(prev, curr, mv, **kw)
        # both sides blanked: the blend is 0 there, and > 0 elsewhere
        assert bool((blend == 0).any()) and bool((blend > 0).any())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_matmul_wrapper_takes_the_plain_version_on_cpu(mode, dtype):
    prev, curr, mv, r, kw, _ = _matmul_case(mode, dtype, 16, 32, 64, 0.5, 3)
    before = warp_blend_matmul.launches
    got = warp_blend_matmul(prev, curr, mv, **kw)
    cropped = warp_blend_matmul(prev, curr, mv, crop=(30, 48), **kw)
    ref = warp_blend_matmul_plain(prev, curr, mv, **kw)
    assert warp_blend_matmul.launches == before
    assert torch.equal(_bits(got), _bits(ref))
    assert cropped.is_contiguous()
    assert torch.equal(_bits(cropped), _bits(ref[:, :30, :48]))


def test_block_wrapper_takes_the_plain_version_on_cpu():
    prev, curr, mv = _frames(4, 4, 32, 64, 16, 8)
    before = warp_blend_block.launches
    got = warp_blend_block(prev, curr, mv, factor=0.25, search_radius=8)
    assert warp_blend_block.launches == before
    ref = warp_blend_block_plain(prev, curr, mv, factor=0.25,
                                 search_radius=8)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("kwargs", [dict(bilinear=True, integer_offsets=True),
                                    dict(bilinear=True, block=4),
                                    dict(mc_fallback=True, block=12),
                                    dict(dtype=torch.float16)])
def test_plain_and_wrapper_refuse_alike(kwargs):
    g = kwargs.get("block", 16)
    x = torch.zeros((4, 48, 48) if g == 12 else (4, 32, 32))
    mv = torch.zeros((2, x.shape[1] // g, x.shape[2] // g))
    for fn in (warp_blend_matmul, warp_blend_matmul_plain):
        with pytest.raises(ValueError):
            fn(x, x, mv, **kwargs)


@pytest.mark.parametrize("fn", [warp_blend_matmul, warp_blend_matmul_plain],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("crop", [(33, 64), (32, 65), (0, 64), (32, 0)])
def test_wrapper_refuses_a_crop_outside_the_frame(crop, fn):
    """The crop is checked before the dispatch: the CPU, and the plain
    version on any device, refuse what the kernel path refuses."""
    x = torch.zeros((4, 32, 64))
    mv = torch.zeros((2, 2, 4))
    with pytest.raises(ValueError):
        fn(x, x, mv, crop=crop)
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x[:3], mv)

