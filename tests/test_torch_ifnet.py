"""RIFE's own network (IFNet + Contextnet + U-Net, ``models/ifnet.py``) on
the port's learned path (CPU), held to the benchmark's plain reference
(``fgbench/reference/rife_ifnet.py``, the one reference of the network;
tpufg has no IFNet).  Published widths, seeded recipe weights
(``checkpoints/rife_ifnet_seed.json``), small frames.

Tolerances:
- the step against the reference in bf16: at most 3% of the bytes more
  than one code off and a mean gap under half a code.  The program rounds
  to bf16 where the reference does, but its convs sum in another order
  (and on the CPU oneDNN adds the bias inside the conv), so a few bf16
  roundings of a conv's output land on the other side; such a flip in an
  IFBlock's output moves a 16-pixel patch of the flow by about 0.1%, and
  a pixel on a strong edge of the texture by two codes or more.  The same
  reference in float8 e4m3 (the benchmark's control) puts over 15% of the
  bytes more than one code off;
- the weights' three forms, the stream cache against the step without it,
  the space-to-depth rewrites' zero terms: bitwise;
- the operation counts: exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from fgbench import check, counts_ifnet, load
from fgbench.reference import rife_ifnet
from fgbench.spec import ROOT
from tpufg_torch import cli
from tpufg_torch.config import ConfigError, EngineConfig
from tpufg_torch.engine import pipeline
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.kernels.common import plain_versions
from tpufg_torch.models import ifnet, rife

CPU = torch.device("cpu")
RECIPE = os.path.join(ROOT, "checkpoints", "rife_ifnet_seed.json")
CONFIG = os.path.join(ROOT, "fgbench", "configs", "c6-4k-rife-ifnet.json")


@pytest.fixture(scope="module")
def params():
    return rife.load_params(RECIPE)


def _cfg(h, w, scale, **kw):
    return EngineConfig(input_width=w, input_height=h, output_width=w,
                        output_height=h, motion_mode="learned",
                        learned_scale=scale, **kw)


def _wire(frame):
    return torch.from_numpy(frame.view(np.int32).reshape(frame.shape[:2]))


def _step_numbers(params, h, w, scale, seed, precisions):
    """The benchmark's comparison of the step's outputs on two bank pairs
    with the reference in each of ``precisions``."""
    cfg = _cfg(h, w, scale)
    bank = load.make_bank(seed, h, w, 3, 5, CPU)
    step = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                     model_params=params)
    kept = {i: [o.numpy().view(np.uint8).reshape(h, w, 4)
                for o in step(_wire(bank[i - 1]), _wire(bank[i]))]
            for i in (1, 2)}
    conf = {"engine": cfg.__dict__, "checkpoint": RECIPE}
    return {prec: check.compare(kept, "rgba", bank,
                                rife_ifnet.make(conf, prec, CPU, ROOT), CPU)
            for prec in precisions}


@pytest.mark.parametrize("hw,scale,seed", [
    ((128, 192), 1.0, 2 ** 31 + 7), ((128, 192), 0.5, 2 ** 31 + 8),
    ((100, 150), 0.5, 2 ** 31 + 9), ((100, 150), 1.0, 2 ** 31 + 10)])
def test_step_matches_the_reference(params, hw, scale, seed):
    nums = _step_numbers(params, *hw, scale, seed, ("bf16",))["bf16"]
    assert nums["missing_frames"] == 0
    assert nums["frames_compared"] == 2
    assert nums["bad_byte_share"] <= 0.03, nums


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_the_float8_reference_is_not_correct(params, scale):
    nums = _step_numbers(params, 128, 192, scale, 2 ** 31 + 11,
                         ("bf16", "fp8"))
    assert nums["bf16"]["bad_byte_share"] <= 0.03
    assert nums["fp8"]["bad_byte_share"] > 0.15, nums


def test_the_step_moves_pixels(params):
    """The recipe's weights do work: the midpoint is neither frame nor
    their mean, and a constant alpha stays 255."""
    h, w = 96, 160
    bank = load.make_bank(2 ** 31 + 12, h, w, 2, 5, CPU)
    step = pipeline.make_interp_step(_cfg(h, w, 0.5), wire="i32",
                                     device=CPU, model_params=params)
    mid = step(_wire(bank[0]), _wire(bank[1]))[0].numpy().view(
        np.uint8).reshape(h, w, 4).astype(np.int16)
    for ref in (bank[0], bank[1], (bank[0].astype(np.int16) + bank[1]) / 2):
        assert np.abs(mid[..., :3] - ref[..., :3]).mean() > 4
    assert (mid[..., 3] == 255).all()


# ------------------------------------------------------------------ weights

def _state(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_the_three_forms_load_the_same_tensors(params, tmp_path):
    sd = _state(params)
    npz = tmp_path / "w.npz"
    np.savez(npz, **sd)
    pth = tmp_path / "flownet.pkl"
    teacher = {"module.block_tea.conv0.0.0.weight": torch.zeros(45, 20, 3,
                                                                3)}
    torch.save({**{f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
                **teacher}, pth)
    for path in (npz, pth):
        got = rife.load_params(str(path))
        assert rife.is_ifnet(got) and rife.head_name(got) == "ifnet"
        assert list(got) == list(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        ref = rife_ifnet.read_weights(str(path))
        for k, v in sd.items():
            np.testing.assert_array_equal(ref[k], v, err_msg=k)
    ref = rife_ifnet.read_weights(RECIPE)
    assert sorted(ref) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(ref[k], v, err_msg=k)
    assert ifnet.n_params(params) == 10_071_550


def test_the_recipe_is_the_benchmark_configurations(params):
    conf = json.load(open(CONFIG))
    assert os.path.join(ROOT, conf["checkpoint"]) == RECIPE
    assert conf["reference"] == "rife_ifnet"
    recipe = json.load(open(RECIPE))
    assert set(recipe["init"]["gains"]) == set(ifnet.GAINED)
    # He-normal for PReLU(0.25): 2 / (1.0625 fan_in)
    w = np.asarray(params["block0.convblock.3.0.weight"])
    assert abs(w.std() - np.sqrt(2 / (1.0625 * 240 * 9))) < 2e-3
    assert not np.asarray(params["unet.down2.conv1.0.bias"]).any()
    assert (np.asarray(params["unet.up1.1.weight"]) == 0.25).all()


@pytest.mark.parametrize("edit,match", [
    (lambda sd: sd.update({"block9.x.weight": np.zeros(1, np.float32)}),
     "block9.x.weight"),
    (lambda sd: sd.pop("unet.conv.bias"), "unet.conv.bias"),
    (lambda sd: sd.update({"unet.conv.bias": np.zeros(4, np.float32)}),
     "unet.conv.bias"),
    (lambda sd: sd.update({"unet.conv.bias": np.zeros(3, np.float64)}),
     "unet.conv.bias"),
])
def test_a_key_shape_or_dtype_that_does_not_fit_is_named(params, tmp_path,
                                                        edit, match):
    sd = _state(params)
    edit(sd)
    path = tmp_path / "bad.npz"
    np.savez(path, **sd)
    with pytest.raises(ValueError, match=match):
        rife.load_params(str(path))
    with pytest.raises(ValueError):
        rife_ifnet.read_weights(str(path))


def test_a_recipe_of_another_architecture_is_refused(tmp_path):
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"architecture": "unet", "seed": 1}))
    with pytest.raises(ValueError, match="architecture"):
        rife.load_params(str(path))


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


def test_the_stream_cache_gives_the_steps_bytes(params):
    h, w, n = 96, 160, 4
    bank = load.make_bank(2 ** 31 + 13, h, w, n, 5, CPU)
    cfg = _cfg(h, w, 0.5)
    sink = _ListSink()
    stats = run_stream(cfg, _Bank(list(bank)), sink, paced=False, device=CPU,
                       model_params=params)
    assert stats.frames_in == n and len(sink.frames) == 2 * n - 1
    step = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                     model_params=params)
    np.testing.assert_array_equal(sink.frames[0], bank[0])
    for i in range(1, n):
        mid, curr = (o.numpy().view(np.uint8).reshape(h, w, 4)
                     for o in step(_wire(bank[i - 1]), _wire(bank[i])))
        np.testing.assert_array_equal(sink.frames[2 * i - 1], mid)
        np.testing.assert_array_equal(sink.frames[2 * i], curr)


def test_make_q_init_is_the_steps_own_cache(params):
    h, w = 96, 160
    bank = load.make_bank(2 ** 31 + 14, h, w, 3, 5, CPU)
    cfg = _cfg(h, w, 1.0)
    fed = pipeline.make_interp_step(cfg, wire="i32", device=CPU,
                                    model_params=params, q_feed=True)
    q0 = pipeline.make_q_init(cfg, params, CPU)(_wire(bank[0]))
    *_, q1 = fed(_wire(bank[0]), _wire(bank[1]), q0)
    want = pipeline.make_q_init(cfg, params, CPU)(_wire(bank[1]))
    assert len(q1) == 4
    for a, b in zip(q1, want):
        assert torch.equal(a, b)


def test_the_plain_path_calls_no_kernel_wrapper(params, monkeypatch):
    """Inside ``plain_versions()`` the step, its stream cache and
    make_q_init reach every one of the six kernels' plain versions through
    their wrappers and launch nothing, and give the bytes of the step
    outside it."""
    from tpufg_torch.kernels import accum, merge, pack, prelu, warp_grid
    h, w = 96, 160
    bank = load.make_bank(2 ** 31 + 15, h, w, 3, 5, CPU)
    cfg = _cfg(h, w, 0.5)
    twins = [(accum, "ifnet_accum_plain"), (merge, "ifnet_merge_plain"),
             (pack, "pack_nhwc_plain"), (prelu, "bias_prelu_plain"),
             (warp_grid, "warp_plain"),
             (warp_grid, "warp_features_into_plain")]
    wrappers = [ifnet.ifnet_accum, ifnet.ifnet_merge, ifnet.pack_nhwc,
                ifnet.bias_prelu, ifnet.warp_frames, ifnet.warp_features_into]
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
            outs.append(o)
        return outs, q

    want = run()
    launches = [fn.launches for fn in wrappers]
    calls.clear()
    with plain_versions():
        got = run()
    assert sorted(calls) == sorted(name for _, name in twins)
    assert [fn.launches for fn in wrappers] == launches
    for a, b in zip(want[0], got[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(want[1], got[1]))


@pytest.mark.parametrize("kw,precision,named", [
    (dict(fps_multiplier=3), "fast", "--fps-multiplier 3"),
    (dict(interpolation_factor=0.25), "fast", "--interpolation-factor 0.25"),
    (dict(), "exact", "--precision exact"),
])
def test_unported_settings_are_refused_by_name(params, kw, precision, named):
    cfg = _cfg(64, 64, 0.5, **kw)
    assert any(named in s for s in pipeline.unported_settings(
        cfg, precision, params))
    with pytest.raises(NotImplementedError, match=named):
        pipeline.make_interp_step(cfg, precision, device=CPU,
                                  model_params=params)


def test_across_a_scene_cut_the_midpoint_is_curr(params):
    h, w = 64, 96
    bank = load.make_bank(2 ** 31 + 15, h, w, 2, 5, CPU)
    cut = 255 - bank[1]
    cut[..., 3] = 255
    step = pipeline.make_interp_step(
        _cfg(h, w, 1.0, scene_cut_threshold=0.3), wire="i32", device=CPU,
        model_params=params)
    mid, curr = step(_wire(bank[0]), _wire(cut))
    assert torch.equal(mid, curr)
    mid, curr = step(_wire(bank[0]), _wire(bank[1]))
    assert not torch.equal(mid, curr)


def test_the_scale_is_the_ifnets_own():
    v3 = rife.load_params(rife.bundled_checkpoint())
    with pytest.raises(NotImplementedError, match="--learned-scale 0.5"):
        pipeline.check_ported(_cfg(64, 64, 0.5), "fast", v3)
    pipeline.check_ported(_cfg(64, 64, 1.0), "fast", v3)
    with pytest.raises(ConfigError, match="learned scale"):
        _cfg(64, 64, 0.3).validate()
    args = cli.build_parser().parse_args(
        ["x", "--motion-mode", "learned", "--learned-scale", "0.5",
         "--model-path", RECIPE])
    assert cli._config(args).learned_scale == 0.5
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["x", "--learned-scale", "3"])


def test_the_space_to_depth_rewrites_are_the_published_layers(params):
    """The three full-size layers the program runs at half size on
    space-to-depth tensors: the same sums (f32, at most the order of the
    terms differs)."""
    F = torch.nn.functional
    g = torch.Generator().manual_seed(0)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    d = ifnet._s2d_weights(params)
    pack = ifnet.pack_nhwc
    x = torch.rand((1, 4, 24, 40), generator=g)
    got = F.conv2d(pack([x[:, :3]], 16, s2d=True).float(),
                   d["contextnet.conv1.conv1.0.weight@s2d"])
    want = F.conv2d(x[:, :3].to(torch.bfloat16).float(),
                    p["contextnet.conv1.conv1.0.weight"], None, 2, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    from tpufg_torch.kernels.pack import space_to_depth
    y = torch.randn((1, 64, 12, 20), generator=g)
    got = F.conv2d(y, d["unet.up3.0.weight@s2d"], None, 1, 1)
    want = F.conv_transpose2d(y, p["unet.up3.0.weight"], None, 2, 1)
    torch.testing.assert_close(got, space_to_depth(want), rtol=0, atol=1e-4)
    z = torch.randn((1, 16, 24, 40), generator=g)
    got = F.conv2d(space_to_depth(z), d["unet.conv.weight@s2d"], None, 1, 1)
    want = F.conv2d(z, p["unet.conv.weight"], None, 1, 1)
    torch.testing.assert_close(got[:, :12], space_to_depth(want), rtol=0,
                               atol=1e-5)
    assert not got[:, 12:].any()


# ------------------------------------------------------------------ counts

def test_a_4k_pair_is_985_gflop():
    h, w = counts_ifnet.padded(2160, 3840, 0.5)
    assert (h, w) == (2176, 3840)
    assert counts_ifnet.pair_flops(h, w, 0.5) == 985_418_181_120
    assert [counts_ifnet.ifblock_flops(ci, c, h, w, s) for (ci, c), s in
            zip(counts_ifnet.BLOCKS, (8, 4, 2))] == [
        72_648_806_400, 116_142_912_000, 170_874_316_800]
    assert counts_ifnet.context_flops(h, w) == 54_747_463_680
    assert counts_ifnet.unet_flops(h, w) == 571_004_682_240
    # the other scales pad to max(32, 32 / s)
    assert counts_ifnet.padded(2160, 3840, 0.25) == (2176, 3840)
    assert counts_ifnet.padded(1080, 1920, 1.0) == (1088, 1920)
