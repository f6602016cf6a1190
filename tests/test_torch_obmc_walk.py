"""The walks of config 4q's two warp kernels on Hopper, emulated in plain
torch on the CPU and held bitwise to the plain versions.

csrc/warp_obmc.cu (the per-pixel warp): a block of 32 x ROWS threads
first makes, in shared memory, the per-column offsets of the bands its
rows read, from the MV lattice (the clipped MV times the side's scale at
two lattice columns, fused along x with ``jax.image.resize``'s taps); a
thread then owns V columns x RT rows that lie between the same two band
sites, splits each band's offset of each column once, walks the RT + 1
tap rows of each band once (a tap row's horizontal sums serve the two
output rows they lie between), blends the two bands per row and masks
each side from the staged band rows; blend mode writes prev's term, then
adds curr's.  csrc/warp_epilogue.cu: the cells pass keeps each pixel's
two fallback terms in shared memory and sums a cell's rows left to right,
then the row sums top to bottom; the blend resizes along x, once per
block, the cell rows its tile reads, then each pixel along y.

In bf16 the kernel rounds two channels at once and does the vertical
lerp and the band blend on bf16 pairs, one rounding of each exact result;
``test_bf16_pair_ops_round_once`` holds those operations to the plain
version's (an f32 result rounded to bf16).

The emulation follows those structures (which band a thread reads, which
staged row a mask reads, the tap rows a thread shares) with one rounding
per operation, and is held bitwise to ``warp_obmc_plain``,
``fallback_cells_plain`` and ``warp_epilogue_plain`` over modes, types,
block sizes, blend factors, a column-padded width with ``valid_w``, MVs
past every edge and the crop.  The kernels themselves are held to the
plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tpufg_torch.kernels.resize import fused_lerp, linear_taps
from tpufg_torch.kernels.warp_matmul import (FB_CELL, _fallback_terms,
                                             _pad_columns,
                                             fallback_cells_plain,
                                             obmc_offsets, warp_epilogue,
                                             warp_epilogue_plain, warp_obmc,
                                             warp_obmc_plain, warp_pair_plain)

F32 = torch.float32


def _bits(x):
    return x.contiguous().view(torch.int32)


def _f32(x):
    return float(np.float32(x))


# ---- the per-pixel warp (csrc/warp_obmc.cu)

def kernel_offsets(mv, r, scale, w):
    """The kernel's offsets [2, H/g, W] f32 of one side, in its order:
    clip(mv, +-r) * scale at lattice columns i0[x] and min(i0[x] + 1,
    W/g - 1), fused with the column taps in f64; numpy scalars' roundings
    (f32 products, one f64 sum rounded to f32)."""
    m = mv.numpy().astype(np.float32)
    n_bx = m.shape[2]
    tx = linear_taps(n_bx, w)
    i0 = tx.i0.numpy()
    i1 = np.minimum(i0 + 1, n_bx - 1)
    clipped = np.minimum(np.maximum(m, np.float32(-r)), np.float32(r))
    a = clipped[..., i0] * np.float32(scale)              # f32 products
    b = clipped[..., i1] * np.float32(scale)
    p = (a * tx.w0.numpy() + np.float32(0)).astype(np.float32)
    out = (p.astype(np.float64)
           + b.astype(np.float64) * tx.w1.numpy().astype(np.float64))
    return torch.from_numpy(out.astype(np.float32))


def band_of(y, g, n_by):
    """The band row y reads first, floor((y - g/2) / g) clipped."""
    return np.where(y < g // 2, 0, np.minimum((y - g // 2) // g, n_by - 1))


def staged_bands(h, g, tile_h, lim_h):
    """Each block row's staged bands [jlo, jhi] (every row of its tile),
    checked against the kernel's room ((tile_h - 1) / 8 + 3 bands) and
    against the row taps: each row's band pair, and its mask's two rows,
    lie in them."""
    n_by = h // g
    ty = linear_taps(n_by, h)
    i0 = ty.i0.numpy()
    ranges = []
    for by0 in range(0, lim_h, tile_h):
        rows = np.arange(by0, min(by0 + tile_h, h))
        jlo = int(band_of(by0, g, n_by))
        jhi = min(int(band_of(rows[-1], g, n_by)) + 1, n_by - 1)
        assert jhi - jlo + 1 <= (tile_h - 1) // 8 + 3
        assert (i0[rows] == band_of(rows, g, n_by)).all()
        assert jlo <= i0[rows].min() and np.minimum(i0[rows] + 1,
                                                    n_by - 1).max() <= jhi
        ranges.append((jlo, jhi))
    return ranges


class Policy:
    """MatmulPolicy<true, false, BF16>: centred values in the moving type,
    the horizontal lerp an f32 sum rounded once, the vertical lerp and the
    band blend in the type."""

    def __init__(self, bf16):
        self.bf16 = bf16

    def dt(self, x):
        return x.to(torch.bfloat16).to(F32) if self.bf16 else x

    def weights(self, f):
        b = self.dt(f)
        return self.dt(1.0 - b), b

    def load(self, x):
        return self.dt(x - 0.5)

    def hlerp(self, a, b, w):
        return self.dt(a * w[0] + b * w[1])

    def vlerp(self, t, b, w):
        return self.dt(self.dt(t * w[0]) + self.dt(b * w[1]))


def obmc_walk(prev, curr, mv, g, r, t, mode, dtype, v=2, rt=4, rows=4,
              crop=None, valid_w=None):
    """warp_obmc by the kernel's walk, every thread at once.  mode:
    "single", "blend" or "pair"."""
    n_ch, h, w = prev.shape
    n_by = h // g
    half = g // 2
    pol = Policy(dtype == torch.bfloat16)
    lim_h, lim_w = (h, w) if mode == "pair" or crop is None else crop
    valid_w = w if valid_w is None else valid_w
    staged_bands(h, g, rows * rt, lim_h)
    t32, omt = _f32(t), _f32(np.float32(1.0) - np.float32(t))
    scales = (1.0,) if mode == "single" else (-t32, omt)
    ty = linear_taps(n_by, h)
    y0 = np.arange(0, lim_h, rt)                      # thread rows [NY]
    x0 = torch.arange(0, lim_w, v)                    # thread columns [NX]
    alone = (y0 < half) | (y0 >= n_by * g - half)
    ja = band_of(y0, g, n_by)
    jb = np.where(alone, ja, ja + 1)
    k0 = np.where(alone, 0, (y0 - half) % g)
    cols = (x0[:, None] + torch.arange(v)).reshape(-1)             # [NX * V]
    # the band blend's weights per thread row and row
    wy = pol.dt(torch.from_numpy(((k0[:, None] + np.arange(rt)).astype(
        np.float32) + np.float32(0.5)) / np.float32(g)))
    wa = pol.dt(1.0 - wy)
    ys = torch.from_numpy(y0[:, None] + np.arange(rt))          # [NY, RT]

    def band(src, offs, j):
        """One band's values (in the type, unfinished) at every thread's
        rows and columns: [C, NY, RT, NX * V]."""
        dx = offs[0][torch.from_numpy(j)][:, cols]              # [NY, X]
        dy = offs[1][torch.from_numpy(j)][:, cols]
        fx, fy = torch.floor(dx), torch.floor(dy)
        wx, wyb = pol.weights(dx - fx), pol.weights(dy - fy)
        c0 = (cols + fx.long()).clamp(0, w - 1)
        c1 = (cols + fx.long() + 1).clamp(0, w - 1)
        # tap rows y0 + r + floor(dy), r = 0 .. RT: [NY, RT + 1, X]
        tr = (torch.from_numpy(y0)[:, None, None] + torch.arange(rt + 1)[
            None, :, None] + fy.long()[:, None, :]).clamp(0, h - 1)
        hs = pol.hlerp(pol.load(src[:, tr, c0[:, None, :]]),
                       pol.load(src[:, tr, c1[:, None, :]]),
                       (wx[0][:, None], wx[1][:, None]))
        return pol.vlerp(hs[:, :, :-1], hs[:, :, 1:],
                         (wyb[0][:, None], wyb[1][:, None]))

    outs, masks = [], []
    for side, scale in enumerate(scales):
        src = (curr if side else prev).to(F32)
        offs = kernel_offsets(mv, r, scale, w)
        va, vb = band(src, offs, ja), band(src, offs, jb)
        blended = pol.dt(pol.dt(va * wa[:, :, None]) +
                         pol.dt(vb * wy[:, :, None]))
        al = torch.from_numpy(alone)[:, None, None]
        outs.append(torch.where(al, va, blended) + 0.5)
        # the masks from the band rows of each row's taps
        i0 = ty.i0[ys]
        i1 = torch.clamp(i0 + 1, max=n_by - 1)
        w0, w1 = ty.w0[ys][..., None], ty.w1[ys][..., None]
        fxm = fused_lerp(offs[0][i0][..., cols], w0, offs[0][i1][..., cols],
                         w1)
        fym = fused_lerp(offs[1][i0][..., cols], w0, offs[1][i1][..., cols],
                         w1)
        px = cols.to(F32) + fxm
        py = ys.to(F32)[..., None] + fym
        masks.append(((px >= -0.5) & (px <= valid_w - 0.5) & (py >= -0.5)
                      & (py <= h - 0.5)).to(F32))

    def frame(x):
        # [.., NY, RT, X] -> [.., NY * RT, X], cut to the window
        return x.reshape(*x.shape[:-3], -1, x.shape[-1])[..., :lim_h,
                                                          :lim_w]

    if mode == "single":
        return frame(outs[0])
    if mode == "pair":
        return torch.cat([frame(outs[0]), frame(outs[1]),
                          frame(masks[0])[None], frame(masks[1])[None]])
    # blend: prev's term written, then curr's added to it
    term_p = outs[0] * masks[0] * omt
    return frame(term_p + outs[1] * masks[1] * t32)


def _push_out(mv, edge):
    mv[0, :, 0], mv[0, :, -1] = -edge, edge
    mv[1, 0, :], mv[1, -1, :] = -edge, edge
    return mv


def _case(seed, c, h, w, g, r):
    """Code-valued frames and continuous MVs past the clip, the border
    blocks pointing out of the frame."""
    rng = np.random.default_rng(seed)
    prev, curr = (torch.from_numpy(rng.integers(0, 256, (c, h, w)).astype(
        np.float32) * np.float32(1 / 255)) for _ in range(2))
    lim = 2 * r + 6
    mv = rng.uniform(-lim, lim, (2, h // g, w // g))
    return prev, curr, torch.from_numpy(_push_out(mv, lim).astype(np.float32))


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("mode", ["pair", "blend", "single"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("g,h,w", [(8, 40, 64), (16, 48, 64)])
@pytest.mark.parametrize("t", [0.25, 0.5, 0.7])
def test_obmc_walk_bitwise(mode, dtype, g, h, w, t):
    r = 8
    prev, curr, mv = _case(g + h, 3, h, w, g, r)
    kw = dict(factor=t, block=g, search_radius=r, dtype=dtype,
              single=mode == "single", pair=mode == "pair")
    ref = warp_obmc_plain(prev, curr, mv, **kw)
    got = obmc_walk(prev, curr, mv, g, r, t, mode, dtype)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("v,rt,rows", [(4, 4, 4), (2, 4, 4), (4, 2, 8),
                                       (1, 4, 2), (2, 2, 4)])
@pytest.mark.parametrize("mode", ["pair", "blend"])
def test_obmc_walk_cells(v, rt, rows, mode):
    """Other thread cells and block heights (the kernel's knobs OBMC_V,
    OBMC_RT, OBMC_ROWS) give the same values: the bands a block stages
    still hold every row's."""
    g, h, w, r = 8, 48, 64, 16
    prev, curr, mv = _case(v + rt + rows, 4, h, w, g, r)
    kw = dict(factor=0.5, block=g, search_radius=r, dtype=torch.bfloat16,
              pair=mode == "pair")
    ref = warp_obmc_plain(prev, curr, mv, **kw)
    got = obmc_walk(prev, curr, mv, g, r, 0.5, mode, torch.bfloat16, v, rt,
                    rows)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("mode", ["pair", "blend", "single"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_obmc_walk_column_pad_and_valid_w(mode, dtype):
    """A width tpufg pads to a multiple of 128 (192 -> 256): the frames and
    the lattice edge-padded, the masks' right edge the unpadded width."""
    g, h, w, r = 8, 32, 192, 8
    prev, curr, mv = _case(7, 4, h, w, g, r)
    prev, curr, mv = _pad_columns(prev, curr, mv, 256 - w, g)
    kw = dict(factor=0.5, block=g, search_radius=r, dtype=dtype,
              single=mode == "single", pair=mode == "pair", valid_w=w)
    ref = warp_obmc_plain(prev, curr, mv, **kw)
    got = obmc_walk(prev, curr, mv, g, r, 0.5, mode, dtype, valid_w=w)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("mode", ["blend", "single"])
@pytest.mark.parametrize("crop", [(36, 64), (29, 61), (40, 3)])
def test_obmc_walk_crop(mode, crop):
    """The engine's crop and ragged windows: partial cells at the right
    and bottom edges, a block's last rows cut mid-thread."""
    g, h, w, r = 8, 40, 64, 8
    prev, curr, mv = _case(crop[0], 4, h, w, g, r)
    kw = dict(factor=0.5, block=g, search_radius=r, dtype=torch.bfloat16,
              single=mode == "single", crop=crop)
    ref = warp_obmc_plain(prev, curr, mv, **kw)
    got = obmc_walk(prev, curr, mv, g, r, 0.5, mode, torch.bfloat16,
                    crop=crop)
    assert torch.equal(_bits(got), _bits(ref))


def test_obmc_cases_move_past_every_edge():
    """The cases take taps from outside the frame on all four sides, past
    the clip, and the masks blank some samples and keep others."""
    g, h, w, r = 8, 40, 64, 8
    prev, curr, mv = _case(g + h, 3, h, w, g, r)
    assert bool((mv.abs() > r).any())
    md = torch.clamp(mv, -r, r) * 0.5
    assert float(md[0, :, 0].max()) < 0 < float(md[0, :, -1].min())
    assert float(md[1, 0].max()) < 0 < float(md[1, -1].min())
    pair = warp_obmc_plain(prev, curr, mv, block=g, search_radius=r,
                           pair=True)
    masks = pair[-2:]
    assert bool((masks == 0).any()) and bool((masks == 1).any())


@pytest.mark.parametrize("n_by,n_bx,w", [(136, 240, 1920), (90, 160, 1280)],
                         ids=["1080p", "720p"])
@pytest.mark.parametrize("scale", [1.0, -0.5, 0.5, -0.25, 0.75, -0.7,
                                   "omt0.7"])
def test_kernel_offsets_equal_obmc_offsets(n_by, n_bx, w, scale):
    """The offsets the kernel makes from the lattice equal obmc_offsets'
    bitwise at the users' lattices (1080p and 720p on the 8-px lattice),
    for each side's scale."""
    if scale == "omt0.7":
        scale = float(np.float32(1.0) - np.float32(0.7))
    rng = np.random.default_rng(n_bx)
    r = 16
    mv = torch.from_numpy(rng.uniform(-r - 6, r + 6, (2, n_by, n_bx))
                          .astype(np.float32))
    ref = obmc_offsets(mv, r, (_f32(scale),), w)
    assert torch.equal(_bits(kernel_offsets(mv, r, _f32(scale), w)),
                       _bits(ref))


@pytest.mark.parametrize("h,g", [(1088, 8), (1088, 16), (720, 8), (720, 16),
                                 (2160, 8)])
def test_staged_bands_hold_every_row(h, g):
    """At the users' heights every block's rows, their bands and their
    masks' row taps fit the bands the kernel stages (tile heights 8, 16,
    32)."""
    for tile_h in (8, 16, 32):
        staged_bands(h, g, tile_h, h)


def folded_cells(pair, prev, curr, tile=(16, 32)):
    """The cell means as the per-pixel warp makes them in its pair pass
    (mode 3): its tiles hold whole 8 x 8 cells; side 0 keeps each RGB
    channel's wp * mask_p, side 1 subtracts wc * mask_c and adds |.| to
    the pixel's sum channel by channel (across channel groups, in order),
    times fl(1/n); d_cf from the unwarped frames; then a cell's rows left
    to right and the row sums top to bottom (cells_walk's order)."""
    assert tile[0] % FB_CELL == 0 and tile[1] % FB_CELL == 0
    n_ch, h, w = prev.shape
    nc = min(3, n_ch)
    mp, mc = pair[2 * n_ch], pair[2 * n_ch + 1]
    kept = [pair[c] * mp for c in range(nc)]                 # side 0
    acc = None
    for c in range(nc):                                      # side 1
        d = torch.abs(kept[c] - pair[n_ch + c] * mc)
        acc = d if acc is None else acc + d
    inv = _f32(np.float32(1) / np.float32(nc))
    cf = None
    for c in range(nc):
        d = torch.abs(prev[c] - curr[c])
        cf = d if cf is None else cf + d
    out = []
    for t in (acc * inv, cf * inv):
        c8 = t.reshape(h // FB_CELL, FB_CELL, w // FB_CELL, FB_CELL)
        row = c8[..., 0]
        for k in range(1, FB_CELL):
            row = row + c8[..., k]
        tot = row[:, 0]
        for k in range(1, FB_CELL):
            tot = tot + row[:, k]
        out.append(tot * (1.0 / 64))
    return torch.stack(out)


@pytest.mark.parametrize("c,h,w", [(4, 40, 64), (3, 48, 200), (5, 32, 96)])
def test_obmc_folded_cells_bitwise(c, h, w):
    """The pair pass's cell means (warp_obmc(..., cells=True)) equal the
    cells pass's: the emulation above and the CPU wrapper's result both
    hold to fallback_cells_plain of the pair."""
    g, r = 8, 8
    prev, curr, mv = _case(c + h, c, h, w, g, r)
    pair, cells = warp_obmc(prev, curr, mv, block=g, search_radius=r,
                            dtype=torch.bfloat16, pair=True, cells=True)
    ref = fallback_cells_plain(pair, prev, curr)
    assert torch.equal(_bits(cells), _bits(ref))
    assert torch.equal(_bits(folded_cells(pair, prev, curr)), _bits(ref))
    got = warp_epilogue(pair, prev, curr, 0.5, True, True, cells=cells)
    assert torch.equal(_bits(got), _bits(warp_epilogue_plain(
        pair, prev, curr, 0.5, True, True)))


def test_obmc_wrapper_takes_the_plain_version_on_cpu():
    g, h, w, r = 8, 32, 64, 8
    prev, curr, mv = _case(3, 4, h, w, g, r)
    before = warp_obmc.launches
    got = warp_obmc(prev, curr, mv, block=g, search_radius=r, pair=True)
    assert warp_obmc.launches == before
    ref = warp_obmc_plain(prev, curr, mv, block=g, search_radius=r,
                          pair=True)
    assert torch.equal(_bits(got), _bits(ref))


def _bf16_rne(x):
    """float64 values rounded to bf16 (to nearest, ties to even) in one
    step: the 8-bit significand scaled to an integer and rounded by
    np.rint, which is exact in float64."""
    _, e = np.frexp(x)
    scale = np.ldexp(1.0, 8 - e)
    return np.rint(x * scale) / scale


def test_bf16_pair_ops_round_once():
    """The kernel's bf16 pairs multiply and add bf16 values with one
    rounding of the exact result (mul.rn / add.rn.bf16x2); the plain
    version rounds the f32 result to bf16.  They agree: a product of two
    bf16 values is exact in f32, and the f32 sum of two, rounded to bf16,
    is the bf16 of the exact sum (exact in float64 for exponents under 45
    apart), near ties and far apart alike."""
    rng = np.random.default_rng(10)
    n = 200_000
    sig = rng.integers(128, 256, (2, n)).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], (2, n))
    e0 = rng.integers(-30, 10, n)
    ex = np.stack([e0, e0 - rng.integers(0, 40, n)])
    a, b = sign * np.ldexp(sig, ex - 8)                  # bf16 values
    assert np.array_equal(_bf16_rne(a), a) and np.array_equal(_bf16_rne(b),
                                                              b)
    ta, tb = torch.from_numpy(a).float(), torch.from_numpy(b).float()
    # products: exact in f32
    assert np.array_equal((ta * tb).double().numpy(), a * b)
    # sums: f32 then bf16 == bf16 of the exact sum
    plain = (ta + tb).to(torch.bfloat16).double().numpy()
    assert np.array_equal(plain, _bf16_rne(a + b))


# ---- the blend epilogue (csrc/warp_epilogue.cu)

STRIP_CELLS = 32          # the cells pass: cells a block
EP_TILE = (8, 128)        # the blend: rows, columns a block


def cells_walk(pair, prev, curr):
    """The cells pass: each pixel's terms as one block keeps them, a row's
    8 values left to right, then the 8 row sums top to bottom, x 1/64."""
    d_mc, d_cf = _fallback_terms(pair, prev, curr)
    h, w = d_mc.shape
    out = []
    for d in (d_mc, d_cf):
        s = d.reshape(h // FB_CELL, FB_CELL, w // FB_CELL, FB_CELL)
        row = s[..., 0]
        for k in range(1, FB_CELL):          # one thread per (row, cell)
            row = row + s[..., k]
        tot = row[:, 0]
        for k in range(1, FB_CELL):          # one thread per cell
            tot = tot + row[:, k]
        out.append(tot * (1.0 / 64))
    return torch.stack(out)


def epilogue_walk(pair, prev, curr, factor, occlusion, mc_fallback,
                  crop=None):
    """The blend: the cells resized along x once per block (the cell rows
    its 8 rows read, checked against its room of 3), then along y per
    pixel; the occlusion and the blend per pixel as the plain version."""
    n_ch, h, w = prev.shape
    oh, ow = crop or (h, w)
    if not (mc_fallback and h % FB_CELL == 0 and w % FB_CELL == 0):
        return warp_epilogue_plain(pair, prev, curr, factor, occlusion,
                                   mc_fallback, crop)
    cells = cells_walk(pair, prev, curr)
    ny, nx = cells.shape[1:]
    ty, tx = linear_taps(ny, h), linear_taps(nx, w)
    d = torch.empty((2, oh, ow))
    for by0 in range(0, oh, EP_TILE[0]):
        rows = torch.arange(by0, min(by0 + EP_TILE[0], oh))
        clo = int(ty.i0[by0])
        chi = min(int(ty.i0[rows[-1]]) + 1, ny - 1)
        assert chi - clo + 1 <= (EP_TILE[0] - 1) // FB_CELL + 3
        for bx0 in range(0, ow, EP_TILE[1]):
            cols = torch.arange(bx0, min(bx0 + EP_TILE[1], ow))
            m = cells[:, clo:chi + 1]
            rx = fused_lerp(m[..., tx.i0[cols]], tx.w0[cols],
                            m[..., tx.i1[cols]], tx.w1[cols])
            i0, i1 = ty.i0[rows] - clo, ty.i1[rows] - clo
            d[:, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = fused_lerp(
                rx[:, i0], ty.w0[rows][:, None], rx[:, i1],
                ty.w1[rows][:, None])
    t, one_t = _f32(factor), _f32(np.float32(1.0) - np.float32(factor))
    win = (slice(None), slice(0, oh), slice(0, ow))
    wp, wc = pair[:n_ch][win], pair[n_ch:2 * n_ch][win]
    mp, mc = pair[2 * n_ch:2 * n_ch + 1][win], pair[2 * n_ch + 1:][win]
    out = wp * mp * one_t + wc * mc * t
    if occlusion:
        s = torch.abs(wp[0] - wc[0])
        for c in range(1, n_ch):
            s = s + torch.abs(wp[c] - wc[c])
        k = torch.clamp((s * _f32(np.float32(1) / np.float32(n_ch)) - 0.08)
                        * 8.0, 0.0, 1.0)
        chosen = wp * mp if factor <= 0.5 else wc * mc
        out = out * (1.0 - k) + chosen * k
    rel = d[0] / (d[1] + 0.015)
    wfb = torch.clamp((rel - 0.5) / 0.5, 0.0, 1.0)
    cf = prev[win] * one_t + curr[win] * t
    return out * (1.0 - wfb) + cf * wfb


def _pair_case(seed, c, h, w, t):
    g, r = 8, 8
    prev, curr, mv = _case(seed, c, h, w, g, r)
    return warp_pair_plain(prev, curr, mv, factor=t, block=g,
                           search_radius=r, bilinear=True), prev, curr


@pytest.mark.parametrize("c,h,w", [(4, 32, 64), (3, 24, 512), (4, 40, 264)])
def test_cells_walk_bitwise(c, h, w):
    """Widths of one strip (32 cells), of two, and a ragged last strip."""
    pair, prev, curr = _pair_case(w, c, h, w, 0.5)
    assert torch.equal(_bits(cells_walk(pair, prev, curr)),
                       _bits(fallback_cells_plain(pair, prev, curr)))


@pytest.mark.parametrize("occlusion", [True, False])
@pytest.mark.parametrize("t", [0.25, 0.5, 0.7])
@pytest.mark.parametrize("h,w,crop", [(32, 64, None), (40, 264, (36, 263)),
                                      (48, 136, (41, 130))])
def test_epilogue_walk_bitwise(occlusion, t, h, w, crop):
    """The fallback by cells with the options: whole tiles, a ragged tile
    width and height, the crop."""
    pair, prev, curr = _pair_case(h + w, 4, h, w, t)
    ref = warp_epilogue_plain(pair, prev, curr, t, occlusion, True, crop)
    got = epilogue_walk(pair, prev, curr, t, occlusion, True, crop)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("h", [1088, 720, 2160])
def test_epilogue_cell_rows_fit(h):
    """At the users' heights a blend block's 8 rows read at most 3 rows of
    cell means (the kernel's room), whatever the crop."""
    ny = h // FB_CELL
    ty = linear_taps(ny, h)
    for oh in (h, h - 8, h - 3):
        for by0 in range(0, oh, EP_TILE[0]):
            last = min(by0 + EP_TILE[0], oh) - 1
            clo = int(ty.i0[by0])
            chi = min(int(ty.i0[last]) + 1, ny - 1)
            assert chi - clo + 1 <= 3
            assert int(ty.i0[by0:last + 1].min()) >= clo


def test_epilogue_wrapper_takes_the_plain_version_on_cpu():
    pair, prev, curr = _pair_case(5, 4, 32, 64, 0.5)
    before = warp_epilogue.launches
    got = warp_epilogue(pair, prev, curr, 0.5, True, True, crop=(30, 60))
    assert warp_epilogue.launches == before
    ref = warp_epilogue_plain(pair, prev, curr, 0.5, True, True, (30, 60))
    assert torch.equal(_bits(got), _bits(ref))
