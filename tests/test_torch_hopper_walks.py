"""What the Hopper redesigns of lanczos_scale_packed, lanczos_scale_fast and
motion_search_sites rest on, emulated in plain torch on the CPU: the
Lanczos tile walk of csrc/lanczos_stencil.cuh (stage the tile's rows and
columns read off the tap tables, each horizontal tap sum once per input
row, a ring of the last 2a rows, an output row emitted when its last tap
arrives; for the planar kernel over groups of channels, with a store per
channel) and the sites search's candidate order (dy candidates in blocks, dx
inside, merged by (cost, candidate index), the column mask applied to the
row sum), plus the host plans that size the launches. All comparisons are
bitwise. The kernels themselves run in tests/test_torch_cuda.py and
chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpufg_torch.kernels import lanczos as L
from tpufg_torch.kernels import motion as M

MAX_SMEM = 227 * 1024

# (in_h, in_w), (out_h, out_w): 2x, 1.333x, two downscales, sizes smaller
# than a tile, odd sizes, and an input shorter than the taps
SIZES = [((20, 30), (40, 60)), ((18, 24), (24, 32)), ((32, 40), (24, 30)),
         ((40, 64), (10, 16)), ((5, 7), (9, 13)), ((3, 4), (17, 5)),
         ((16, 16), (16, 16)), ((23, 31), (47, 61))]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _image(c, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (c, h, w)).astype(np.float32)
                            * np.float32(1 / 255))


def _tile_walk(img, out_h, out_w, a, tile_w, tile_rows):
    """lanczos_scale by the walk of csrc/lanczos_stencil.cuh::
    separable_tile, one tile at a time, the tile's "threads" as a vector.
    Also returns the most staged rows and columns any tile used."""
    n_ch, ih, iw = img.shape
    taps = 2 * a
    xs, ys = L.axis_starts(iw, out_w, a), L.axis_starts(ih, out_h, a)
    wx = torch.from_numpy(L.axis_taps(iw, out_w, a)[1])
    wy = L.axis_taps(ih, out_h, a)[1]
    out = torch.full((n_ch, out_h, out_w), float("nan"))
    most_rows = most_cols = 0
    for oy0 in range(0, out_h, tile_rows):
        oy1 = min(oy0 + tile_rows, out_h)
        yv0 = int(ys[oy0])
        nrows = int(ys[oy1 - 1]) + taps - yv0
        for ox0 in range(0, out_w, tile_w):
            xv0 = int(xs[ox0]) & ~3
            ncols = int(xs[min(ox0 + tile_w, out_w) - 1]) + taps - xv0
            most_rows, most_cols = max(most_rows, nrows), max(most_cols, ncols)
            rows = np.clip(yv0 + np.arange(nrows), 0, ih - 1)
            cols = np.clip(xv0 + np.arange(ncols), 0, iw - 1)
            stage = img[:, rows][:, :, cols]          # [C, nrows, ncols]
            ox = np.minimum(ox0 + np.arange(tile_w), out_w - 1)
            off = torch.from_numpy(xs[ox] - xv0).long()
            xw = wx[ox]                                # [tile_w, taps]
            ring = [None] * taps
            oy, need = oy0, yv0
            for p in range(nrows):
                j = p % taps
                if yv0 + p >= need:
                    h = stage[:, p, off] * xw[:, 0]
                    for k in range(1, taps):
                        h = h + stage[:, p, off + k] * xw[:, k]
                    ring[j] = h
                while need + taps - 1 == yv0 + p:
                    v = ring[(j + 1) % taps] * wy[oy, 0]
                    for k in range(1, taps):
                        v = v + ring[(j + 1 + k) % taps] * wy[oy, k]
                    keep = ox0 + np.arange(tile_w) < out_w
                    out[:, oy, ox[keep]] = v[:, keep]
                    oy += 1
                    need = int(ys[oy]) if oy < oy1 else 1 << 30
            assert oy == oy1
    return out, most_rows, most_cols


@pytest.mark.parametrize("a", [1, 2, 3, 4])
@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_lanczos_tile_walk_is_bitwise(in_hw, out_hw, a):
    """The tile walk gives lanczos_scale's f32 values bit for bit, with
    tiles smaller than the image, ragged last tiles and one tile larger
    than the image; the packed bytes follow."""
    img = _image(4, *in_hw, seed=a)
    want = L.lanczos_scale(img, *out_hw, a=a)
    for tile_w, tile_rows in ((8, 4), (16, 3), (128, 32)):
        got, _, _ = _tile_walk(img, *out_hw, a, tile_w, tile_rows)
        assert torch.equal(_bits(got), _bits(want)), (tile_w, tile_rows)
    q = torch.round(torch.clamp(got, 0.0, 1.0) * 255.0).to(torch.uint8)
    assert torch.equal(q.permute(1, 2, 0),
                       L.lanczos_scale_packed_plain(img, *out_hw, a=a))


@pytest.mark.parametrize("a", [1, 2, 3, 4])
@pytest.mark.parametrize("in_hw,out_hw", SIZES + [((1080, 1920), (2160, 3840)),
                                                  ((1080, 1920), (1440, 2560)),
                                                  ((2160, 3840), (1080, 1920))])
def test_lanczos_tables_are_clamped_runs(in_hw, out_hw, a):
    """What the walk relies on: every index row of axis_taps is
    clip(start + k), and the starts never decrease."""
    for n_in, n_out in zip(in_hw, out_hw):
        idx, _ = L.axis_taps(n_in, n_out, a)
        start = L.axis_starts(n_in, n_out, a)
        assert start.dtype == np.int32 and start.shape == (n_out,)
        want = np.clip(start[:, None] + np.arange(2 * a), 0, n_in - 1)
        np.testing.assert_array_equal(idx, want)
        assert (np.diff(start) >= 0).all()
        # every tile's span is positive and covers its own taps
        for tile in (1, 7, 32, 128):
            assert L.tile_span(start, tile, 2 * a) >= 2 * a
            assert (L.tile_span(start, tile, 2 * a, align=4)
                    >= L.tile_span(start, tile, 2 * a))


@pytest.mark.parametrize("in_hw,out_hw,a", [
    ((1080, 1920), (2160, 3840), 3), ((720, 1280), (1440, 2560), 3),
    ((1080, 1920), (1440, 2560), 3), ((1440, 2560), (1080, 1920), 3),
    ((1080, 1920), (2160, 3840), 1), ((1080, 1920), (2160, 3840), 4),
    ((64, 128), (48, 96), 2), ((72, 88), (144, 176), 3), ((5, 7), (9, 13), 2),
    ((1080, 1920), (1081, 1919), 3)])
def test_lanczos_plan_fits_and_covers(in_hw, out_hw, a):
    """The plan of every size chip_smoke.py and the cuda lane run is a tile
    walk within 227 KB whose capacities hold every tile's rows and columns
    (the emulated walk reports the most it staged at a small size)."""
    plan = L.lanczos_plan(*in_hw, *out_hw, a)
    assert plan.tile_w == L._TILE_W and plan.tile_rows in L._TILE_ROWS
    assert plan.cols_cap % 4 == 0
    assert plan.smem <= MAX_SMEM == L._MAX_SMEM
    taps = 2 * a
    assert plan.smem == 4 * (plan.rows_cap * 4 * plan.cols_cap
                             + plan.tile_rows * (1 + taps))
    ys = L.axis_starts(in_hw[0], out_hw[0], a)
    xs = L.axis_starts(in_hw[1], out_hw[1], a)
    assert plan.rows_cap == L.tile_span(ys, plan.tile_rows, taps)
    assert plan.cols_cap >= L.tile_span(xs, plan.tile_w, taps, align=4)
    # a taller tile would have left the target, unless this is the tallest
    taller = [r for r in L._TILE_ROWS if r > plan.tile_rows]
    if taller and plan.smem <= L._SMEM_TARGET:
        more = L.lanczos_plan(*in_hw, *out_hw, a, tile_rows=min(taller))
        assert more.smem > L._SMEM_TARGET
    if max(in_hw) <= 128:
        _, rows, cols = _tile_walk(_image(1, *in_hw), *out_hw, a,
                                   plan.tile_w, plan.tile_rows)
        assert rows <= plan.rows_cap and cols <= plan.cols_cap


@pytest.mark.parametrize("in_hw,out_hw", [((2160, 3840), (90, 160)),
                                          ((1080, 60000), (1080, 300)),
                                          ((2160, 3840), (1080, 1920))])
def test_lanczos_plan_gives_way_to_the_direct_stencil(in_hw, out_hw):
    """A downscale so strong that no tile's staged input fits in shared
    memory, or that staging reads more than the direct stencil would: the
    plan names the direct stencil (tile_rows 0), never a tile that does not
    fit."""
    plan = L.lanczos_plan(*in_hw, *out_hw, 3)
    assert plan.tile_rows == 0 and plan.smem == 0
    for rows in L._TILE_ROWS:
        forced = L.lanczos_plan(*in_hw, *out_hw, 3, tile_rows=rows)
        assert (forced.smem > MAX_SMEM
                or forced.rows_cap * 4 * forced.cols_cap
                > L._STAGE_MAX * rows * forced.tile_w)


def _planar_walk(img, out_h, out_w, a, tile_w, tile_rows):
    """lanczos_scale_fast as csrc/lanczos_planar.cu computes it: one tile
    walk per entry of channel_groups and block along z, every channel's f32
    value stored (rounded once for a bf16 stack) into its own plane."""
    out = torch.full((img.shape[0], out_h, out_w), float("nan")).to(img.dtype)
    group, _ = L.planar_plan(img.shape[0], *img.shape[1:], out_h, out_w, a)
    for first, blocks, nch in L.channel_groups(img.shape[0], group):
        for z in range(blocks):
            c0 = first + z * nch
            got, _, _ = _tile_walk(img[c0:c0 + nch].float(), out_h, out_w, a,
                                   tile_w, tile_rows)
            out[c0:c0 + nch] = got.to(img.dtype)
    return out


# 2x up, a downscale, and an output smaller than one tile
PLANAR_SIZES = [((20, 30), (40, 60)), ((32, 40), (24, 30)), ((5, 7), (3, 13))]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("a", [1, 2, 3, 4])
@pytest.mark.parametrize("in_hw,out_hw", PLANAR_SIZES)
@pytest.mark.parametrize("c", [1, 3, 4, 5, 17])
def test_planar_tile_walk_is_bitwise(c, in_hw, out_hw, a, dt):
    """The walk over channel groups with the per-channel epilogue gives
    lanczos_scale_fast_plain's values bit for bit, in f32 and in bf16 (a
    bf16 stack is staged as f32 and rounded once at the store)."""
    img = _image(c, *in_hw, seed=c + a).to(dt)
    want = L.lanczos_scale_fast_plain(img, *out_hw, a=a)
    got = _planar_walk(img, *out_hw, a, 16, 8)
    assert got.dtype == want.dtype == dt
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 7, 8, 17, 64])
def test_channel_groups_cover_every_channel_once(c, group):
    seen = []
    for first, blocks, nch in L.channel_groups(c, group):
        assert blocks >= 1 and 1 <= nch <= group
        seen += list(range(first, first + blocks * nch))
    assert seen == list(range(c))
    # at most two launches: the full groups, then the remainder
    assert len(L.channel_groups(c, group)) <= 2


@pytest.mark.parametrize("c", [1, 3, 4, 5, 17])
@pytest.mark.parametrize("in_hw,out_hw,a", [
    ((1080, 1920), (2160, 3840), 3), ((720, 1280), (1440, 2560), 3),
    ((540, 960), (1080, 1920), 3), ((1440, 2560), (1080, 1920), 3),
    ((2160, 3840), (1080, 1920), 3), ((1080, 1920), (2160, 3840), 4),
    ((2160, 3840), (720, 1280), 3), ((2160, 3840), (540, 960), 3),
    ((2160, 3840), (90, 160), 3), ((72, 88), (50, 200), 2)])
def test_planar_plan_fits_or_is_the_direct_stencil(c, in_hw, out_hw, a):
    """The planar kernel's plan for a stack of c channels names the channels
    a block walks and a tile sized for them, within 227 KB, in which every
    group's launch fits; or it names the direct stencil."""
    group, plan = L.planar_plan(c, *in_hw, *out_hw, a)
    taps = 2 * a
    assert 1 <= group <= min(c, 4)
    # the walk was timed faster than the direct stencil down to a third of
    # the size, slower at a quarter
    assert (plan.tile_rows == 0) == (in_hw[0] >= 4 * out_hw[0])
    if plan.tile_rows == 0:
        assert plan == L.LanczosPlan(L._TILE_W, 0, 0, 0, 0)
        assert group == 1          # no smaller group was left to try
        return
    assert plan == L.lanczos_plan(*in_hw, *out_hw, a, n_ch=group,
                                  stage_max=L._PLANAR_STAGE_MAX)
    assert plan.smem == L.tile_smem_bytes(plan, taps, group) <= MAX_SMEM
    assert plan.smem == 4 * (plan.rows_cap * group * plan.cols_cap
                             + plan.tile_rows * (1 + taps))
    for _, _, nch in L.channel_groups(c, group):
        assert 1 <= nch <= group
        assert L.tile_smem_bytes(plan, taps, nch) <= plan.smem
    # more channels a block would have meant a tile under the minimum rows
    # or over the shared-memory target
    for more in (g for g in L._PLANAR_GROUPS if group < g <= c):
        wider = L.lanczos_plan(*in_hw, *out_hw, a, n_ch=more,
                               stage_max=L._PLANAR_STAGE_MAX)
        assert (wider.tile_rows < L._PLANAR_MIN_ROWS
                or wider.smem > L._SMEM_TARGET)
    if in_hw[0] < out_hw[0] and in_hw[1] < out_hw[1]:
        assert group == min(c, 4)  # upscales walk four channels a block


@pytest.mark.parametrize("r", [0, 1, 4, 8, 16, 64, 256, 584])
def test_sites_plan_fits_shared_memory(r):
    dy_block, smem = M.sites_plan(r)
    assert dy_block == M._SITES_DY_BLOCK >= 1
    assert smem == M.sites_smem_bytes(r, dy_block) <= MAX_SMEM == M._MAX_SMEM
    assert smem == (16 * (7 + dy_block) * (128 + 2 * r)
                    + 2 * dy_block * 128 * 4)
    M._check_smem("motion_search_sites", smem)


def test_sites_plan_too_large_is_refused():
    _, smem = M.sites_plan(585)
    assert smem > MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        M._check_smem("motion_search_sites", smem)


def _blocked_sites_search(prev, curr, r, dy_block):
    """motion_search_sites_plain's search in csrc/motion_sites.cu's order:
    dy candidates in blocks of ``dy_block``, every dx for a block, the
    block's dy innermost; the best kept as the minimum of (cost, candidate
    index) from a start that stands for (0, 0) and ties with nothing; the
    column mask applied as a select on the row sum."""
    n_ch, h, w = prev.shape
    b, g, a = 8, 16, 4
    m, n = h // g, 2 * r + 1
    rows = (torch.arange(m)[:, None] * g + g // 2 - a
            + torch.arange(b)[None, :]).reshape(-1)
    cur = F.pad(curr[:, rows], (a, b - 1 - a))
    pre = F.pad(prev, (r + a, r + b - 1 - a), mode="replicate")
    xs = torch.arange(w + b - 1) - a
    in_col = ((xs >= 0) & (xs < w))[None, :]
    best = torch.full((m, w), 1e10)
    best_k = torch.full((m, w), -1, dtype=torch.int64)
    for dy0 in range(0, n, dy_block):
        for dxi in range(n):
            for j in range(min(dy_block, n - dy0)):
                win = pre[:, torch.clamp(rows + dy0 + j - r, 0, h - 1),
                          dxi:dxi + w + b - 1]
                d = cur[0] - win[0]
                acc = d * d
                for c in range(1, n_ch):
                    d = cur[c] - win[c]
                    acc = acc + d * d
                dist = torch.sqrt(acc).reshape(m, b, w + b - 1)
                rs = dist[:, 0]
                for u in range(1, b):
                    rs = rs + dist[:, u]
                rs = torch.where(in_col, rs, torch.zeros(()))
                cost = rs[:, 0:w]
                for kx in range(1, b):
                    cost = cost + rs[:, kx:kx + w]
                k = (dy0 + j) * n + dxi
                upd = (cost < best) | ((cost == best) & (k < best_k))
                best = torch.where(upd, cost, best)
                best_k = torch.where(upd, k, best_k)
    best_k = torch.where(best_k < 0, r * n + r, best_k)
    return torch.stack([best_k % n - r, best_k // n - r]).float()


def _tie_frames(c, h, w, seed=7):
    """Flat areas, a repeating pattern and one moved patch: many candidates
    cost the same, so the winner is decided by the tie rule."""
    rng = np.random.default_rng(seed)
    prev = np.zeros((c, h, w), np.float32)
    prev[:, :, w // 2:] = np.tile(rng.integers(0, 4, (c, 1, 2)) / 4.0,
                                  (1, h, (w - w // 2) // 2)).astype(np.float32)
    prev[:, 6:14, 3:11] = rng.random((c, 8, 8), dtype=np.float32)
    curr = np.roll(prev, (1, -1), (1, 2))
    return torch.from_numpy(prev), torch.from_numpy(curr)


@pytest.mark.parametrize("dy_block", [1, 2, 3, 4])
@pytest.mark.parametrize("c,r", [(3, 2), (4, 3)])
def test_sites_block_order_is_the_first_minimum(dy_block, c, r):
    prev, curr = _tie_frames(c, 32, 28)
    want = M.motion_search_sites_plain(prev, curr, search_radius=r)
    got = _blocked_sites_search(prev, curr, r, dy_block)
    assert torch.equal(_bits(got), _bits(want))
    # the frame does have ties: some site's winner is the scan's first
    assert float((want == -r).all(0).float().mean()) > 0.05


def test_sites_start_value_wins_no_tie():
    """Costs at or above the start value 1e10 never win, in any order: the
    field stays (0, 0), as in the plain scan."""
    prev = torch.zeros((3, 16, 24))
    curr = torch.full((3, 16, 24), 4e8)
    want = M.motion_search_sites_plain(prev, curr, search_radius=2)
    assert not want.any()
    got = _blocked_sites_search(prev, curr, 2, 4)
    assert torch.equal(_bits(got), _bits(want))
