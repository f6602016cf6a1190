"""What the Hopper redesigns of conv3x3_chain, conv3x3_s2 and
motion_search_tiled add on the host side, which runs on the CPU: the bf16
chain's and the bf16 stride-2 conv's weight packing (the ``mma`` B-fragment
order csrc/conv_chain_mma.cu and csrc/conv_s2_mma.cu read), the stride-2
conv's implicit GEMM emulated in torch, the cache of packed weights, the
shared-memory plans, and the rule by which the tiled search merges
candidates that were split among thread groups.  The kernels themselves
run in tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpufg_torch.kernels import conv as C
from tpufg_torch.kernels import motion as M

BF16 = torch.bfloat16
MAX_SMEM = 227 * 1024


def _weights(chans, seed=0):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy(rng.standard_normal(
        (chans[i + 1], chans[i], 3, 3)).astype(np.float32))
        for i in range(len(chans) - 1)]
    bs = [torch.from_numpy(rng.standard_normal(
        (chans[i + 1],)).astype(np.float32)) for i in range(len(chans) - 1)]
    return ws, bs


@pytest.mark.parametrize("chans", [[13, 5], [17, 5], [13, 64], [17, 64],
                                   [17, 64, 64, 5], [13, 64, 64, 5],
                                   [4, 12, 3], [8, 6], [13, 16, 16, 5]])
def test_chain_pack_round_trip(chans):
    """Unpacking the packed tensor gives back w.to(bfloat16) exactly, and
    everything else in it (padded channels) is zero."""
    ws, bs = _weights(chans)
    wpack, bias = C.pack_chain_weights_bf16(ws, bs)
    assert wpack.dtype == BF16 and bias.dtype == torch.float32
    kcs, nts = C.chain_mma_dims(chans)
    assert wpack.numel() == sum(9 * kc * nt * 128 for kc, nt in zip(kcs, nts))
    for got, w in zip(C.unpack_chain_weights_bf16(wpack, chans), ws):
        assert torch.equal(got, w.to(BF16))
    assert int((wpack != 0).sum()) == sum(int((w.to(BF16) != 0).sum())
                                          for w in ws)
    at = 0
    for b, nt in zip(bs, nts):
        assert torch.equal(bias[at:at + b.numel()], b)
        assert not bias[at + b.numel():at + 8 * nt].any()
        at += 8 * nt
    assert at == bias.numel()


def _fragment_value(wpack, base, kc_n, nt_n, tap, kc, nt, lane, reg, e):
    """The bf16 value csrc/conv_chain_mma.cu's lane ``lane`` finds in
    register ``reg`` (element ``e`` of the pair) of n8 tile ``nt``'s B
    fragment for ``tap`` and k16 chunk ``kc``: 256 bytes per (tap, chunk,
    tile); a lane reads 16 bytes per pair of tiles at [pair][lane], or 8
    bytes at [lane] when the layer has one tile."""
    step = base + (tap * kc_n + kc) * nt_n * 128       # in bf16 elements
    if nt_n == 1:
        return wpack[step + lane * 4 + reg * 2 + e]
    return wpack[step + ((nt // 2) * 32 + lane) * 8 + (nt % 2) * 4
                 + reg * 2 + e]


@pytest.mark.parametrize("chans", [[17, 64, 64, 5], [13, 16, 5]])
def test_chain_pack_is_the_mma_b_fragment_order(chans):
    """mma.m16n8k16's B operand: lane 4 g + t holds B[k][n] for n = g and
    k = 2 t + 8 reg + e.  With B[k][n] = w[8 tile + n][16 chunk + k] of a
    tap, every lane's registers hold the weights the instruction expects."""
    ws, bs = _weights(chans, seed=1)
    wpack, _ = C.pack_chain_weights_bf16(ws, bs)
    kcs, nts = C.chain_mma_dims(chans)
    rng = np.random.default_rng(2)
    base = 0
    for w, kc_n, nt_n in zip(ws, kcs, nts):
        wb = w.to(BF16)
        for _ in range(200):
            tap, kc, nt = (int(rng.integers(9)), int(rng.integers(kc_n)),
                           int(rng.integers(nt_n)))
            lane, reg, e = (int(rng.integers(32)), int(rng.integers(2)),
                            int(rng.integers(2)))
            n = 8 * nt + lane // 4
            k = 16 * kc + 2 * (lane % 4) + 8 * reg + e
            want = (wb[n, k, tap // 3, tap % 3]
                    if n < w.shape[0] and k < w.shape[1] else 0.0)
            got = _fragment_value(wpack, base, kc_n, nt_n, tap, kc, nt, lane,
                                  reg, e)
            assert float(got) == float(want)
        base += 9 * kc_n * nt_n * 128


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_chain_pack_cache(dtype):
    ws, bs = _weights([13, 16, 5], seed=3)
    first = C.packed_chain_weights(ws, bs, dtype)
    # the same tensors, in a new tuple: the cached pack
    assert C.packed_chain_weights(tuple(ws), tuple(bs), dtype) is first
    # the other dtype has a pack of its own
    other = BF16 if dtype == torch.float32 else torch.float32
    assert C.packed_chain_weights(ws, bs, other) is not first
    # an in-place update packs anew, with the new values
    ws[0].mul_(2.0)
    second = C.packed_chain_weights(ws, bs, dtype)
    assert second is not first
    if dtype == BF16:
        assert torch.equal(
            C.unpack_chain_weights_bf16(second[0], [13, 16, 5])[0],
            ws[0].to(BF16))
    else:
        assert torch.equal(second[0][0][:, :, :16],
                           ws[0].permute(2, 3, 1, 0).reshape(9, 13, 16))
    # equal values in new tensors are new tensors
    clones = [w.clone() for w in ws]
    assert C.packed_chain_weights(clones, bs, dtype) is not second
    assert C.packed_chain_weights(ws, bs, dtype) is second


def test_chain_pack_cache_is_bounded_and_never_stale():
    """Weights come and go (a freed tensor's id and storage may be taken by
    the next one): the cache stays small, and every answer is the pack of
    the tensors it was asked about."""
    for seed in range(3 * C._PACK_CACHE_SIZE):
        ws, bs = _weights([4, 3], seed=seed)
        wpack, bias = C.packed_chain_weights(ws, bs, BF16)
        assert len(C._PACK_CACHE) <= C._PACK_CACHE_SIZE
        assert torch.equal(C.unpack_chain_weights_bf16(wpack, [4, 3])[0],
                           ws[0].to(BF16))
        assert torch.equal(bias[:3], bs[0])
        del ws, bs


def _s2_weights(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, .2, (cout, cin, 3, 3))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(0, .1, (cout,)).astype(np.float32))
    return w, b


@pytest.mark.parametrize("cin,cout", [(4, 32), (8, 32), (4, 20), (8, 3)])
def test_s2_gemm_weights_order(cin, cout):
    """Weight (co, ci, dy, dx) sits at row dy * Kpad + dx * Cin + ci, column
    co, rounded to bf16; the pad rows of every dy slice and the columns past
    Cout are zero."""
    w, _ = _s2_weights(cin, cout)
    wk = C.s2_gemm_weights(w)
    kpad = {4: 16, 8: 32}[cin]
    assert wk.dtype == BF16 and tuple(wk.shape) == (3 * kpad, 32)
    wb = w.to(BF16)
    for dy in range(3):
        for dx in range(3):
            for ci in range(cin):
                assert torch.equal(wk[dy * kpad + dx * cin + ci, :cout],
                                   wb[:, ci, dy, dx])
        assert not wk[dy * kpad + 3 * cin:(dy + 1) * kpad].any()
    assert not wk[:, cout:].any()
    assert int((wk != 0).sum()) == int((wb != 0).sum())


@pytest.mark.parametrize("cin,cout", [(4, 32), (8, 32), (4, 20), (8, 3)])
def test_s2_pack_round_trip_and_fragment_order(cin, cout):
    """The packed tensor unpacks to the GEMM matrix exactly, and holds it in
    mma.m16n8k16's B-fragment order: lane 4 g + t finds, for k16 step s and
    n8 tile n, B[16 s + 8 reg + 2 t + e][8 n + g] at [s][lane][n][reg][e]
    (32 bytes a lane and step, read as two 16-byte loads)."""
    w, b = _s2_weights(cin, cout, seed=1)
    wk = C.s2_gemm_weights(w)
    wpack, bias = C.pack_s2_weights_bf16(w, b)
    assert wpack.dtype == BF16 and wpack.is_contiguous()
    assert wpack.numel() == wk.numel()
    assert torch.equal(C.unpack_s2_weights_bf16(wpack), wk)
    assert bias.dtype == torch.float32 and tuple(bias.shape) == (32,)
    assert torch.equal(bias[:cout], b) and not bias[cout:].any()
    frag = wpack.reshape(wk.shape[0] // 16, 32, 4, 2, 2)
    rng = np.random.default_rng(2)
    for _ in range(300):
        s, lane, n, reg, e = (int(rng.integers(m)) for m in
                              (frag.shape[0], 32, 4, 2, 2))
        g, t = lane // 4, lane % 4
        assert float(frag[s, lane, n, reg, e]) == float(
            wk[16 * s + 8 * reg + 2 * t + e, 8 * n + g])


def _s2_implicit_gemm(x, w, b, tile):
    """conv3x3_s2 in bf16 as csrc/conv_s2_mma.cu computes it, one output
    tile (rows, cols) at a time: stage the tile's input rows and columns
    channels-last with zeros past the image, round once to bf16, take for
    every output pixel and dy the Kpad contiguous values from staged column
    2 ox as a row of A, multiply [pixels, K] by the [K, 32] weight matrix
    in f32, add the bias."""
    cin, h, wd = x.shape
    cout = w.shape[0]
    oh, ow = h // 2, wd // 2
    rows, cols = tile
    kpad = C.s2_gemm_weights(w).shape[0] // 3
    span = kpad // cin                       # staged pixels a dy slice spans
    wk = C.s2_gemm_weights(w).float()
    out = torch.full((cout, oh, ow), float("nan"))
    for oy0 in range(0, oh, rows):
        for ox0 in range(0, ow, cols):
            st = torch.zeros((2 * rows + 1, 2 * cols + 4, cin))
            src = x[:, 2 * oy0:2 * oy0 + st.shape[0],
                    2 * ox0:2 * ox0 + st.shape[1]]
            st[:src.shape[1], :src.shape[2]] = src.permute(1, 2, 0)
            st = st.to(BF16).float()
            a = torch.stack([
                torch.cat([st[2 * r + dy, 2 * c:2 * c + span].reshape(-1)
                           for dy in range(3)])
                for r in range(rows) for c in range(cols)])
            y = (a @ wk).reshape(rows, cols, 32).permute(2, 0, 1)[:cout]
            y = y + b[:, None, None]
            nr, nc = min(rows, oh - oy0), min(cols, ow - ox0)
            out[:, oy0:oy0 + nr, ox0:ox0 + nc] = y[:, :nr, :nc]
    return out


@pytest.mark.parametrize("cin,cout,h,w,tile", [
    (4, 32, 32, 64, (8, 16)), (8, 32, 32, 64, (8, 16)),
    # ragged last tiles both ways, Cout < 32, a frame smaller than a tile
    (4, 32, 36, 150, (8, 64)), (8, 20, 36, 150, (8, 64)),
    (4, 5, 22, 70, (4, 32)), (8, 32, 6, 10, (8, 64))])
def test_s2_implicit_gemm_matches_plain(cin, cout, h, w, tile):
    rng = np.random.default_rng(cin + h)
    x = torch.from_numpy(rng.random((cin, h, w), np.float32))
    wt, b = _s2_weights(cin, cout, seed=3)
    want = C.conv3x3_s2_plain(x, wt, b, BF16)
    got = _s2_implicit_gemm(x, wt, b, tile)
    assert got.shape == want.shape == (cout, h // 2, w // 2)
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-6


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_s2_pack_cache(dtype):
    w, b = _s2_weights(4, 32, seed=4)
    first = C.packed_s2_weights(w, b, dtype)
    assert C.packed_s2_weights(w, b, dtype) is first
    other = BF16 if dtype == torch.float32 else torch.float32
    assert C.packed_s2_weights(w, b, other) is not first
    # an in-place update packs anew, with the new values
    w.mul_(2.0)
    second = C.packed_s2_weights(w, b, dtype)
    assert second is not first
    if dtype == BF16:
        assert torch.equal(C.unpack_s2_weights_bf16(second[0]),
                           C.s2_gemm_weights(w))
    else:
        assert torch.equal(second[0], w.permute(1, 2, 3, 0).reshape(36, 32))
    b.add_(1.0)
    third = C.packed_s2_weights(w, b, dtype)
    assert third is not second and torch.equal(third[1], b)
    # equal values in new tensors are new tensors; the cache is shared with
    # the chain's and stays bounded
    assert C.packed_s2_weights(w.clone(), b, dtype) is not third
    assert C.packed_s2_weights(w, b, dtype) is third
    assert len(C._PACK_CACHE) <= C._PACK_CACHE_SIZE


@pytest.mark.parametrize("chans", [[17, 64, 64, 5], [13, 64, 64, 5],
                                   [13, 16, 16, 5], [8, 6], [4, 12, 3]])
def test_chain_layouts_fit_shared_memory(chans):
    """Every chain chip_smoke.py and the cuda lane run fits the 227 KB a
    block may use, in both dtypes; the bf16 layout ends with exactly the
    packed weights."""
    tile = C._CHAIN_TILE[BF16]
    off, w_off, total = C.chain_mma_layout(chans, tile)
    ws, bs = _weights(chans)
    wpack, _ = C.pack_chain_weights_bf16(ws, bs)
    assert 0 <= off <= w_off and off % 16 == 0 and w_off % 16 == 0
    assert total - w_off == 2 * wpack.numel()
    assert total <= MAX_SMEM == C._MAX_SMEM
    n_layers = len(chans) - 1
    kcs, _ = C.chain_mma_dims(chans)
    rows, pitch = tile[0] + 2 * n_layers, tile[1] + 2 * n_layers
    # buffer 0 holds the input tile, buffer 1 the first layer's output
    assert off >= rows * pitch * kcs[0] * 32
    if n_layers > 1:
        assert w_off - off >= (rows - 2) * pitch * kcs[1] * 32
    off32, total32 = C.chain_smem_layout(chans, C._CHAIN_TILE[torch.float32])
    assert 0 < off32 <= total32 <= MAX_SMEM


def test_chain_path_layout_is_the_one_the_kernel_documents():
    assert C._CHAIN_TILE[BF16] == (8, 32)
    assert C.chain_mma_dims([17, 64, 64, 5]) == ([2, 4, 4], [8, 8, 1])
    assert C.chain_mma_dims([13, 64, 64, 5]) == ([1, 4, 4], [8, 8, 1])
    assert C.chain_mma_layout([17, 64, 64, 5], (8, 32)) == (48640, 107008,
                                                            226816)


@pytest.mark.parametrize("b,r,exact", [(16, 16, False), (12, 4, False),
                                       (8, 16, True), (16, 16, True),
                                       (8, 4, False), (4, 4, True),
                                       (16, 2, True), (32, 16, False)])
def test_tiled_plan_fits_shared_memory(b, r, exact):
    """Every tiled search chip_smoke.py and the cuda lane run gets a plan
    within 227 KB; the compiled-in block sizes get the taller tile."""
    rows, groups, smem = M.tiled_plan(b, r, exact)
    assert smem == M.tiled_smem_bytes(b, r, exact, rows, groups)
    assert smem <= MAX_SMEM == M._MAX_SMEM
    assert 1 <= groups <= M._TILED_MAX_GROUPS
    assert rows == (M._TILED_ROWS_FAST if b in M._TILED_FAST_B
                    else M._TILED_ROWS_ANY)
    if groups < M._TILED_MAX_GROUPS:
        assert M.tiled_smem_bytes(b, r, exact, rows, groups + 1) > MAX_SMEM
    # the groups' bests merge in the space of the curr and prev tiles
    ext = rows + b - 1
    assert (groups - 1) * rows * 128 * 8 <= 16 * ext * (256 + 2 * r)


def test_tiled_plan_too_large_is_refused():
    _, _, smem = M.tiled_plan(64, 64, True)
    assert smem > MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        M._check_smem("motion_search_tiled", smem)


def _grouped_search(prev, curr, b, r, exact, groups):
    """motion_search_tiled_plain's search with each dy's dx candidates dealt
    to ``groups`` scanners in turns, as csrc/motion_tiled.cu deals them to
    its thread groups: each scanner keeps its first minimum by a strict <,
    and the scanners merge by (cost, candidate index)."""
    n_ch, h, w = prev.shape
    a = b // 2
    n = 2 * r + 1
    cur = F.pad(curr, (a, b - 1 - a, a, b - 1 - a))
    pre = F.pad(prev[None], (r + a, r + b - 1 - a, r + a, r + b - 1 - a),
                mode="replicate")[0]
    ys = torch.arange(h + b - 1) - a
    xs = torch.arange(w + b - 1) - a
    mask = (((ys >= 0) & (ys < h))[:, None]
            & ((xs >= 0) & (xs < w))[None, :]).float()
    box = M._exact_box(b, w) if exact else M._separable_box(b, w)
    best = [torch.full((h, w), 1e10) for _ in range(groups)]
    best_k = [torch.full((h, w), r * n + r, dtype=torch.int64)
              for _ in range(groups)]
    for dyi in range(n):
        rows = pre[:, dyi:dyi + h + b - 1]
        for dxi in range(n):
            g = dxi % groups
            win = rows[:, :, dxi:dxi + w + b - 1]
            d = cur[0] - win[0]
            acc = d * d
            for c in range(1, n_ch):
                d = cur[c] - win[c]
                acc = acc + d * d
            cost = box(torch.sqrt(acc) * mask)
            upd = cost < best[g]
            best[g] = torch.where(upd, cost, best[g])
            best_k[g] = torch.where(upd, dyi * n + dxi, best_k[g])
    out, out_k = best[0], best_k[0]
    for g in range(1, groups):
        upd = (best[g] < out) | ((best[g] == out) & (best_k[g] < out_k))
        out = torch.where(upd, best[g], out)
        out_k = torch.where(upd, best_k[g], out_k)
    return torch.stack([out_k % n - r, out_k // n - r]).float()


@pytest.mark.parametrize("groups", [2, 3, 5])
@pytest.mark.parametrize("b,r,exact", [(4, 2, False), (4, 3, True)])
def test_tiled_group_merge_is_the_first_minimum(groups, b, r, exact):
    """On a frame full of ties (flat areas, a repeating pattern, one moved
    patch) the merged result equals the single scan's first minimum bit for
    bit: ties go to the smallest candidate index."""
    rng = np.random.default_rng(7)
    h, w = 20, 28
    prev = np.zeros((3, h, w), np.float32)
    prev[:, :, 14:] = np.tile(rng.integers(0, 4, (3, 1, 2)) / 4.0,
                              (1, h, 7)).astype(np.float32)
    prev[:, 6:12, 3:9] = rng.random((3, 6, 6), dtype=np.float32)
    curr = np.roll(prev, (1, -1), (1, 2))
    prev, curr = torch.from_numpy(prev), torch.from_numpy(curr)
    want = M.motion_search_tiled_plain(prev, curr, b, r, exact_box=exact)
    got = _grouped_search(prev, curr, b, r, exact, groups)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the frame does have ties: some pixel's winner is not unique
    assert float((want == -r).all(0).float().mean()) > 0.05
