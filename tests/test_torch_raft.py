"""RAFT's optical flow (``models/raft.py``) as the learned motion of the
port's learned path (CPU), held to the benchmark's plain reference
(``fgbench/reference/raft_flow.py``, the one reference of the network;
tpufg has no RAFT).  Published widths, seeded recipe weights
(``checkpoints/raft_seed.json``), small frames, torch on one thread (the
model's small convs run several times slower on many).

Tolerances:
- the step against the reference in bf16: the configuration's
  ``bad_byte_share`` limit, and the flow within 0.05 px mean and 0.25 px
  at most of the reference's (end-point error at full size).  The program
  rounds to bf16 where the reference does, but oneDNN's convs sum in
  another order, so a bf16 rounding of a conv's output lands on the other
  side now and then, and 12 updates carry it into the coordinates: 0.012
  px mean, 0.04-0.06 px at most seen, and no byte more than one code off.
  The same reference in float8 e4m3 (the benchmark's control) puts 17-29%
  of the bytes more than one code off;
- the weights' three forms, the stream cache against the step without it,
  the plain path against the step, the graphed flow against the eager
  one: bitwise;
- the pyramid's levels against avg_pool2d, the pooling kernel's walk, the
  operation counts: exact.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fgbench import check, counts_raft, load
from fgbench.reference import head, raft_flow
from fgbench.spec import ROOT
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine import pipeline
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.kernels.common import plain_versions
from tpufg_torch.kernels.convert import frames_to_planar
from tpufg_torch.models import raft, rife

CPU = torch.device("cpu")
RECIPE = os.path.join(ROOT, "checkpoints", "raft_seed.json")
CONFIG = os.path.join(ROOT, "fgbench", "configs", "c7-1080p-4k-raft.json")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return rife.load_params(RECIPE)


def _cfg(h, w, **kw):
    return EngineConfig(input_width=w, input_height=h, output_width=w,
                        output_height=h, motion_mode="learned", **kw)


def _wire(frame):
    return torch.from_numpy(frame.view(np.int32).reshape(frame.shape[:2]))


def _u8(out, h, w):
    return out.numpy().view(np.uint8).reshape(h, w, 4)


def _limit():
    return json.load(open(CONFIG))["limits"]["bad_byte_share"]


def _step_numbers(params, h, w, seed, precisions, **kw):
    """The benchmark's comparison of the step's outputs on two bank pairs
    with the reference in each of ``precisions``."""
    cfg = _cfg(h, w, **kw)
    bank = load.make_bank(seed, h, w, 3, 5, CPU)
    step = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                     model_params=params)
    kept = {i: [_u8(o, h, w) for o in step(_wire(bank[i - 1]),
                                           _wire(bank[i]))]
            for i in (1, 2)}
    conf = {"engine": cfg.__dict__, "checkpoint": RECIPE}
    return {prec: check.compare(kept, "rgba", bank,
                                raft_flow.make(conf, prec, CPU, ROOT), CPU)
            for prec in precisions}


@pytest.mark.parametrize("hw,seed", [((128, 160), 2 ** 31 + 21),
                                     ((124, 150), 2 ** 31 + 22)])
def test_step_matches_the_reference(params, hw, seed):
    nums = _step_numbers(params, *hw, seed, ("bf16",))["bf16"]
    assert nums["missing_frames"] == 0 and nums["frames_compared"] == 2
    assert nums["bad_byte_share"] <= _limit(), nums


@pytest.mark.parametrize("hw,seed", [((128, 160), 2 ** 31 + 23),
                                     ((124, 150), 2 ** 31 + 24)])
def test_the_flow_matches_the_references(params, hw, seed):
    """End-point error of the full-size flow, the pad (124 x 150 -> 128 x
    152, 2 + 2 rows and 1 + 1 columns) cut back."""
    h, w = hw
    bank = load.make_bank(seed, h, w, 2, 5, CPU)
    p, c = (frames_to_planar(_wire(b)) for b in bank)
    dev = raft.to_device(params, CPU)
    q0 = raft.frame_cache(dev, raft.pad_rgb(p))
    q1 = raft.frame_cache(dev, raft.pad_rgb(c))
    flow = raft.crop(raft.refine(dev, q0, raft.corr_pyramid(q0[0], q1[0])),
                     h, w)
    ref = raft_flow.make({"engine": _cfg(h, w).__dict__,
                          "checkpoint": RECIPE}, "bf16", CPU, ROOT)
    left, right, top, bottom = raft.padding(h, w)
    with head.no_tf32():
        want = ref.flow(*(F.pad(x[None, :3], (left, right, top, bottom),
                                mode="replicate") for x in (p, c)))
    want = want[0, :, top:top + h, left:left + w]
    assert flow.shape == (2, h, w)
    epe = (flow - want).norm(dim=0)
    assert epe.mean() <= 0.05 and epe.max() <= 0.25, (epe.mean(), epe.max())
    # the recipe's flow is a few px, as a 1080p clip's is
    assert 1.0 < float(flow.norm(dim=0).median()) < 30.0


def test_the_float8_reference_is_not_correct(params):
    nums = _step_numbers(params, 128, 160, 2 ** 31 + 25, ("bf16", "fp8"))
    assert nums["bf16"]["bad_byte_share"] <= _limit()
    assert nums["fp8"]["bad_byte_share"] > 2 * _limit(), nums


def test_the_step_moves_pixels(params):
    """The recipe's flow does work: the midpoint is neither frame nor
    their mean, and a constant alpha stays 255."""
    h, w = 128, 160
    bank = load.make_bank(2 ** 31 + 26, h, w, 2, 5, CPU)
    step = pipeline.make_interp_step(_cfg(h, w), wire="i32", device=CPU,
                                     model_params=params)
    mid = _u8(step(_wire(bank[0]), _wire(bank[1]))[0], h, w).astype(
        np.int16)
    for ref in (bank[0], bank[1], (bank[0].astype(np.int16) + bank[1]) / 2):
        assert np.abs(mid[..., :3] - ref[..., :3]).mean() > 2
    assert (mid[..., 3] == 255).all()


# ------------------------------------------------------------------ weights

def _state(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_the_recipe_has_the_published_keys_and_shapes(params):
    shapes = raft.layer_shapes()
    assert list(params) == list(shapes)
    assert raft.n_params(params) == 5_257_536
    assert shapes["update_block.encoder.convc1.weight"] == (256, 324, 1, 1)
    assert shapes["update_block.gru.convq2.weight"] == (128, 384, 5, 1)
    assert shapes["update_block.mask.2.weight"] == (576, 256, 1, 1)
    assert shapes["cnet.layer2.0.downsample.1.running_var"] == (96,)
    assert not any(k.startswith("fnet") and "norm" in k for k in shapes)
    assert sorted(raft_flow.keys()) == sorted(shapes)
    recipe = json.load(open(RECIPE))
    assert set(recipe["init"]["gains"]) == set(raft.GAINED)
    # He-normal for ReLU: 2 / fan_in
    w = np.asarray(params["fnet.layer2.1.conv1.weight"])
    assert abs(w.std() - np.sqrt(2 / (96 * 9))) < 2e-3
    assert not np.asarray(params["update_block.gru.convz1.bias"]).any()
    assert (np.asarray(params["cnet.norm1.running_var"]) == 1).all()
    conf = json.load(open(CONFIG))
    assert os.path.join(ROOT, conf["checkpoint"]) == RECIPE
    assert conf["reference"] == "raft_flow" and conf["reduced"] == []
    assert {"weights", "updates", "precision", "blend"} <= set(
        conf["assumed"])


def test_the_three_forms_load_the_same_tensors(params, tmp_path):
    sd = _state(params)
    npz = tmp_path / "w.npz"
    np.savez(npz, **sd)
    pth = tmp_path / "raft-things.pth"
    published = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    for k in list(sd):
        if k.endswith(".downsample.1.weight"):
            # the published state dict holds each downsample norm twice
            alias = k.replace("downsample.1", "norm3")
            published[f"module.{alias}"] = torch.from_numpy(sd[k])
        if k.endswith(".running_var"):
            published[f"module.{k[:-len('running_var')]}"
                      "num_batches_tracked"] = torch.tensor(0)
    torch.save(published, pth)
    for path in (npz, pth):
        got = rife.load_params(str(path))
        assert rife.is_raft(got) and rife.head_name(got) == "raft"
        assert list(got) == list(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        ref = raft_flow.read_weights(str(path))
        for k, v in sd.items():
            np.testing.assert_array_equal(ref[k], v, err_msg=k)
    ref = raft_flow.read_weights(RECIPE)
    assert sorted(ref) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(ref[k], v, err_msg=k)


@pytest.mark.parametrize("form", ["npz", "pth"])
def test_telling_raft_weights_apart_reads_only_key_names(params, tmp_path,
                                                          monkeypatch, form):
    """``load_params`` asks every file whether it is RAFT's before another
    head's loader reads it: the question reads the key names alone (no
    array of c5's head, no tensor of a ``.pth``), for RAFT's weights and
    for the bundled v3d head's ``.npz``."""
    sd = _state(params)
    path = tmp_path / f"w.{form}"
    if form == "npz":
        np.savez(path, **sd)
    else:
        torch.save({f"module.{k}": torch.from_numpy(v)
                    for k, v in sd.items()}, path)

    def unread(*a, **k):
        raise AssertionError("read the arrays")

    monkeypatch.setattr(raft, "_read_state", unread)
    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", unread)
    assert raft.looks_like(str(path))
    assert not raft.looks_like(os.path.join(ROOT, "checkpoints",
                                            "head64_v4.npz"))


@pytest.mark.parametrize("edit,match", [
    (lambda sd: sd.update({"fnet.x.weight": np.zeros(1, np.float32)}),
     "fnet.x.weight"),
    (lambda sd: sd.pop("update_block.mask.2.bias"), "update_block.mask.2"),
    (lambda sd: sd.update({"cnet.conv2.bias": np.zeros(4, np.float32)}),
     "cnet.conv2.bias"),
])
def test_a_key_or_shape_that_does_not_fit_is_named(params, tmp_path, edit,
                                                   match):
    sd = _state(params)
    edit(sd)
    path = tmp_path / "bad.npz"
    np.savez(path, **sd)
    with pytest.raises(ValueError, match=match):
        raft.load(str(path))
    with pytest.raises(ValueError):
        raft_flow.read_weights(str(path))


def test_a_recipe_of_another_architecture_is_not_raft(tmp_path):
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"architecture": "rife_ifnet", "seed": 1}))
    assert not raft.looks_like(str(path))
    with pytest.raises(ValueError, match="architecture"):
        raft.load(str(path))


# -------------------------------------------------------------- the path

class _ListSink(FrameSink):
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))


class _Bank:
    const_alpha = True

    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        return iter(self.frames)


@pytest.mark.parametrize("k", [2, 3])
def test_the_stream_cache_gives_the_steps_bytes(params, k):
    """The engine with its stream cache against the step without it, at x2
    and x3 (t = 1/3 and 2/3)."""
    h, w, n = 128, 160, 3
    bank = load.make_bank(2 ** 31 + 27, h, w, n, 5, CPU)
    cfg = _cfg(h, w, fps_multiplier=k)
    sink = _ListSink()
    stats = run_stream(cfg, _Bank(list(bank)), sink, paced=False, device=CPU,
                       model_params=params)
    assert stats.frames_in == n and len(sink.frames) == k * (n - 1) + 1
    step = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                     model_params=params)
    np.testing.assert_array_equal(sink.frames[0], bank[0])
    for i in range(1, n):
        outs = [_u8(o, h, w) for o in step(_wire(bank[i - 1]),
                                           _wire(bank[i]))]
        assert len(outs) == k
        for j, o in enumerate(outs):
            np.testing.assert_array_equal(sink.frames[k * (i - 1) + 1 + j], o)


def test_make_q_init_is_the_steps_own_cache(params):
    h, w = 124, 150
    bank = load.make_bank(2 ** 31 + 28, h, w, 2, 5, CPU)
    cfg = _cfg(h, w)
    fed = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                    model_params=params, q_feed=True)
    q_init = pipeline.make_q_init(cfg, params, CPU)
    *_, q1 = fed(_wire(bank[0]), _wire(bank[1]), q_init(_wire(bank[0])))
    want = q_init(_wire(bank[1]))
    assert len(q1) == 3
    assert [tuple(t.shape) for t in q1] == [(1, 256, 16, 19),
                                            (1, 128, 16, 19),
                                            (1, 128, 16, 19)]
    for a, b in zip(q1, want):
        assert torch.equal(a, b)


def test_the_plain_path_calls_no_kernel_wrapper(params, monkeypatch):
    """Inside ``plain_versions()`` the step and make_q_init reach the plain
    versions of RAFT's kernels (the lookup, the pyramid's pooling, the
    upsampling, the GRU's two passes), the bias add, the pack and the warp
    through their wrappers, launch nothing, and give the bytes of the step
    outside it."""
    from tpufg_torch.kernels import (convex_upsample, corr_lookup,
                                     corr_pool, pack, prelu, raft_gru,
                                     warp_grid)
    h, w = 128, 160
    bank = load.make_bank(2 ** 31 + 29, h, w, 3, 5, CPU)
    cfg = _cfg(h, w)
    twins = [(corr_lookup, "corr_lookup_plain"),
             (corr_pool, "corr_pool_plain"),
             (convex_upsample, "convex_upsample_plain"),
             (prelu, "bias_prelu_plain"), (raft_gru, "gru_gates_plain"),
             (raft_gru, "gru_update_plain"),
             (pack, "pack_nhwc_plain"), (warp_grid, "warp_plain")]
    wrappers = [corr_lookup.corr_lookup, corr_pool.corr_pool,
                convex_upsample.convex_upsample, prelu.bias_prelu,
                raft_gru.gru_gates, raft_gru.gru_update, pack.pack_nhwc,
                warp_grid.warp_frames]
    calls = {}
    for mod, name in twins:
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    def run():
        step = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                         model_params=params, q_feed=True)
        q = pipeline.make_q_init(cfg, params, CPU)(_wire(bank[0]))
        outs = []
        for i in (1, 2):
            *o, q = step(_wire(bank[i - 1]), _wire(bank[i]), q)
            outs += o
        return outs + list(q)

    want = run()
    launches = [fn.launches for fn in wrappers]
    calls.clear()
    with plain_versions():
        got = run()
    # make_q_init and 2 pairs: a frame's encoders take 32 bias adds, an
    # update 7, the mask 2
    assert calls == {"corr_lookup_plain": 24, "corr_pool_plain": 2,
                     "convex_upsample_plain": 2, "bias_prelu_plain": 268,
                     "gru_gates_plain": 48, "gru_update_plain": 48,
                     "pack_nhwc_plain": 3, "warp_plain": 2}
    assert [fn.launches for fn in wrappers] == launches
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_the_graphed_flow_gives_the_eager_bytes(params):
    """``RaftFlow`` through a graph backend (``FakeGraphs``: its replay
    reruns the function on the static inputs and copies the results into
    the captured outputs) against the eager flow over 3 pairs with the
    cache threaded: the frames and the caches bitwise, one warm-up and one
    capture on the first pair, a replay a pair.  The cache handed back is
    the graph's static output, which its next call copies in as prev's
    before the replay overwrites it."""
    from tests.test_torch_graph import FakeGraphs
    h, w = 124, 150
    bank = load.make_bank(2 ** 31 + 31, h, w, 4, 5, CPU)
    dev = rife.params_to_torch(params, CPU)
    planar = [frames_to_planar(_wire(b)) for b in bank]
    fake = FakeGraphs()
    got = []
    for flow in (pipeline.RaftFlow(dev), pipeline.RaftFlow(dev, fake)):
        q = raft.frame_cache(dev, raft.pad_rgb(planar[0]))
        outs = []
        for i in (1, 2, 3):
            mids, q = pipeline.raft_planar(planar[i - 1], planar[i], flow,
                                           [0.5], q)
            outs += [m.clone() for m in mids] + [t.clone() for t in q]
        got.append(outs)
    assert (fake.warms, fake.captures, fake.replays) == (1, 1, 3)
    assert len(got[0]) == len(got[1]) == 12
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize("kw,precision,named", [
    (dict(temporal_mv=True), "fast", "--temporal-mv"),
    (dict(), "exact", "--precision exact"),
    (dict(learned_scale=0.5), "fast", "--learned-scale 0.5"),
])
def test_unported_settings_are_refused_by_name(params, kw, precision, named):
    cfg = _cfg(64, 64, **kw)
    assert any(named in s and "RAFT" in s.upper() for s in
               pipeline.unported_settings(cfg, precision, params))
    with pytest.raises(NotImplementedError, match=named):
        pipeline.make_interp_step(cfg, precision, device=CPU,
                                  model_params=params)


@pytest.mark.parametrize("k", [2, 3])
def test_across_a_scene_cut_each_frame_is_the_nearer_source(params, k):
    h, w = 128, 160
    bank = load.make_bank(2 ** 31 + 30, h, w, 2, 5, CPU)
    cut = 255 - bank[1]
    cut[..., 3] = 255
    step = pipeline.make_interp_step(
        _cfg(h, w, scene_cut_threshold=0.3, fps_multiplier=k), wire="i32",
        device=CPU, model_params=params)
    *mids, curr = step(_wire(bank[0]), _wire(cut))
    for j, mid in enumerate(mids):
        t = (j + 1) / k
        assert torch.equal(mid, _wire(bank[0]) if t < 0.5 else curr)
    *mids, curr = step(_wire(bank[0]), _wire(bank[1]))
    assert not any(torch.equal(m, curr) for m in mids)


def _pool_walk(h, w):
    """``csrc/corr_pool.cu``'s walk of one pixel's map, emulated: the
    level-0 rows and columns each 8 x 8 block reads, and the cells of
    levels 1-3 it writes, as its launcher sizes the grid."""
    h1, w1, h2, w2 = h // 2, w // 2, h // 4, w // 4
    h3, w3 = h2 // 2, w2 // 2
    bys, bxs = (2 * h1 + 7) // 8, (2 * w1 + 7) // 8
    reads, writes = set(), [[], [], []]
    for by in range(bys):
        for bx in range(bxs):
            for i in range(4):
                r1 = by * 4 + i
                if r1 >= h1:
                    break
                for j in range(4):
                    c1 = bx * 4 + j
                    if c1 < w1:
                        reads |= {(2 * r1 + dy, 2 * c1 + dx)
                                  for dy in (0, 1) for dx in (0, 1)}
                        writes[0].append((r1, c1))
            for i in range(2):
                for j in range(2):
                    r2, c2 = by * 2 + i, bx * 2 + j
                    if r2 < h2 and c2 < w2:
                        # its four level-1 cells are this block's own
                        assert 2 * r2 + 1 < min(h1, by * 4 + 4)
                        assert 2 * c2 + 1 < min(w1, bx * 4 + 4)
                        writes[1].append((r2, c2))
            if by < h3 and bx < w3:
                writes[2].append((by, bx))
    return reads, writes, ((h1, w1), (h2, w2), (h3, w3))


@pytest.mark.parametrize("hw", [(135, 240), (16, 19), (17, 30), (8, 8),
                                (9, 23)])
def test_the_pool_kernels_walk_writes_every_cell_once(hw):
    """Each cell of levels 1-3 is written by exactly one block, from
    level-0 values inside the map (an odd size's last row or column never
    read), at 1080p's 1/8 grid, a padded 124 x 150 frame's and odd
    sizes."""
    reads, writes, sizes = _pool_walk(*hw)
    h, w = hw
    assert all(0 <= r < 2 * (h // 2) and 0 <= c < 2 * (w // 2)
               for r, c in reads)
    assert len(reads) == 4 * (h // 2) * (w // 2)
    for cells, (hl, wl) in zip(writes, sizes):
        assert sorted(cells) == [(r, c) for r in range(hl) for c in range(wl)]


def test_the_pyramid_is_three_average_pools(params):
    """``corr_pyramid``'s levels 1-3 are the published avg_pool2d of the
    level before (the plain version on the CPU)."""
    q = raft.frame_cache(rife.params_to_torch(params, CPU),
                         torch.rand(3, 64, 80))
    pyr = raft.corr_pyramid(q[0], q[0])
    assert [tuple(t.shape) for t in pyr] == [(80, 1, 8, 10), (80, 1, 4, 5),
                                             (80, 1, 2, 2), (80, 1, 1, 1)]
    for a, b in zip(pyr, pyr[1:]):
        assert torch.equal(b, F.avg_pool2d(a, 2, stride=2))


# ------------------------------------------------------------------ counts

def test_a_1080p_pair_is_3210_gflop():
    h, w = counts_raft.padded(1080, 1920)
    assert (h, w) == (1080, 1920)
    assert counts_raft.pair_flops(h, w) == 3_210_596_352_000
    assert counts_raft.corr_flops(h, w) == 537_477_120_000
    assert 2 * counts_raft.encoder_flops(h, w) == 563_621_068_800
    assert counts_raft.update_flops(h, w) == 173_402_726_400
    assert counts_raft.mask_flops(h, w) == 28_665_446_400
    # a lookup's patches and outputs, 12 a pair; the upsampling's mask,
    # flow and output
    assert counts_raft.lookup_bytes(h, w) == 874_022_400
    assert counts_raft.upsample_bytes(h, w) == 54_172_800
    assert counts_raft.padded(124, 150) == (128, 152)
