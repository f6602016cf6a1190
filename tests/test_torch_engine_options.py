"""The streaming engine's options through tpufg_torch against tpufg (CPU):
``--scene-cut``, ``--fps-multiplier`` k > 2, ``--temporal-mv``, the
device-side y4m egress, and the engine with all of them.

Same numpy frames through both packages; each tpufg step is compiled once
per module.  Tolerances (the existing contracts of tests/test_torch_
pipeline.py, tests/test_torch_quality_step.py and tests/test_torch_
learned.py):
- MV fields, the temporal seed threaded over a stream included: bitwise
  (the seed's cell mean sums in XLA's order, ``seed_cell_mean``);
- across a scene cut: each in-between frame is the nearer source, byte for
  byte, in both packages, and the next seed is all zeros;
- in-between frames at identity size: within 1 code, on at most 3% of the
  bytes for the warps (tpufg's compiled CPU blend contracts into FMAs,
  which moves .5 quantization ties) and 1e-3 for the learned head; the
  crossfade within 1 code and bitwise to tpufg's formula with one
  rounding an operation (at t = k/4 many of its bytes are exact .5 ties);
  curr: bitwise (passed through);
- the y4m payload: bitwise to tpufg's and to the host egress.
The cut's detector sums in torch's order, not XLA's: the pairs here sit
far from the threshold (asserted), so the decision cannot flip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.config import EngineConfig as JConfig
from tpufg.engine import pipeline as jpipe
from tpufg.engine.runner import run_stream as jrun_stream
from tpufg.io.sinks import Y4MSink as JY4MSink
from tpufg.io.sources import SyntheticSource
from tpufg.kernels import yuv as jyuv
from tpufg.models import rife as jrife
from tpufg.models.pyramid import TEMPORAL_CLAMP as JTEMPORAL_CLAMP
from chip_smoke import (SEEDED_HIT_MIN, UNSEEDED_HIT_MAX, track_frames,
                        track_hit)
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine import pipeline
from tpufg_torch.engine.runner import StreamingEngine, run_stream
from tpufg_torch.io.sinks import Y4MSink, _down2x2, _rgb_to_bt601
from tpufg_torch.kernels import yuv
from tpufg_torch.kernels.convert import frames_to_planar
from tpufg_torch.models import pyramid, rife

CPU = torch.device("cpu")
THR = 0.1                     # --scene-cut
H, W = 64, 128                # identity-size steps (the pyramid's lattice)
LH, LW = 48, 80               # the learned head's (16-px lattice)
Q = dict(mv_grid=1, subpel=True, mv_bias=0.1, mv_filter=True,
         mc_fallback=True, occlusion_blend=True)
MODES = {"none": {}, "pyramid": {},
         "exhaustive": dict(motion_mode="exhaustive", search_radius=4),
         "4q": Q, "learned": dict(motion_mode="learned")}


def _i32(f: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(f).view(np.int32).reshape(f.shape[:2])


def _pairs(h, w):
    """{"cut": two unrelated frames (a smooth pan texture, then uniform
    noise), "no-cut": two frames of a pan} as packed int32 [h, w]."""
    pan = [_i32(f) for f in SyntheticSource(w, h, n_frames=2,
                                            velocity=(3.0, 1.0))]
    noise = _i32(next(iter(SyntheticSource(w, h, n_frames=1,
                                           pattern="noise", seed=1))))
    return {"cut": (pan[0], noise), "no-cut": (pan[0], pan[1])}


def _mean_abs_rgb(a, b):
    x, y = (frames_to_planar(torch.from_numpy(f))[:3] for f in (a, b))
    return float((x - y).abs().mean())


def _sizes(h, w, oh=None, ow=None):
    return dict(input_width=w, input_height=h, output_width=ow or w,
                output_height=oh or h)


@pytest.fixture(scope="module")
def heads():
    path = rife.bundled_checkpoint()
    return jrife.load_params(path), rife.load_params(path)


@pytest.fixture(scope="module")
def steps(heads):
    """(mode, k, cut) -> (tpufg's step, the port's step), each built once
    (tpufg's compiles on its first call)."""
    built = {}

    def get(mode, k, cut):
        key = (mode, k, cut)
        if key not in built:
            opts = dict(MODES[mode], fps_multiplier=k,
                        scene_cut_threshold=THR if cut else 0.0)
            if mode == "none":
                opts["motion_mode"] = "none"
            hw = (LH, LW) if mode == "learned" else (H, W)
            jp_, tp_ = (heads[0], heads[1]) if mode == "learned" else (
                None, None)
            built[key] = (
                jpipe.make_interp_step(JConfig(**_sizes(*hw), **opts),
                                       wire="i32", model_params=jp_),
                pipeline.make_interp_step(EngineConfig(**_sizes(*hw), **opts),
                                          wire="i32", device=CPU,
                                          model_params=tp_))
        return built[key]

    return get


def _diff(a, b):
    a = np.asarray(a).view(np.uint8).astype(np.int16)
    b = np.asarray(b).view(np.uint8).astype(np.int16)
    assert a.shape == b.shape
    return np.abs(a - b)


def _run_pair(steps, mode, k, cut, pair):
    jstep, tstep = steps(mode, k, cut)
    prev, curr = pair
    ref = jstep(jnp.asarray(prev), jnp.asarray(curr))
    out = tstep(torch.from_numpy(prev), torch.from_numpy(curr))
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


@pytest.mark.parametrize("which", ["cut", "no-cut"])
@pytest.mark.parametrize("mode", ["none", "pyramid", "exhaustive", "4q",
                                  "learned"])
def test_scene_cut_matches_tpufg(steps, mode, which):
    """At x4 with --scene-cut: across the cut the t = 0.25 frame is prev
    and the t = 0.5, 0.75 frames are curr, byte for byte, in both
    packages; on the pan the in-between frames are interpolated, within
    the mode's contract of tpufg's."""
    h, w = (LH, LW) if mode == "learned" else (H, W)
    prev, curr = _pairs(h, w)[which]
    # far from the threshold next to the ~1e-8 that a sum order moves d
    d = _mean_abs_rgb(prev, curr)
    assert d > THR + 0.1 if which == "cut" else d < THR - 0.02
    ref, out = _run_pair(steps, mode, 4, True, (prev, curr))
    assert len(out) == len(ref) == 4
    np.testing.assert_array_equal(out[-1], curr)
    np.testing.assert_array_equal(ref[-1], curr)
    if which == "cut":
        for o, r, src in zip(out, ref, (prev, curr, curr)):
            np.testing.assert_array_equal(o, src)
            np.testing.assert_array_equal(r, src)
        return
    frac = 1e-3 if mode == "learned" else 0.03
    for o, r, tf in zip(out[:-1], ref[:-1], (0.25, 0.5, 0.75)):
        dd = _diff(o, r)
        assert dd.max() <= 1 and not np.array_equal(o, curr)
        if mode != "none":
            assert (dd > 0).mean() <= frac
            continue
        # the crossfade of two codes at t = k/4 lands on exact .5 ties
        # often, which tpufg's FMA-contracted blend rounds its own way: its
        # bytes are held to tpufg's formula, one rounding an operation
        pf, cf = (frames_to_planar(torch.from_numpy(x)).numpy()
                  for x in (prev, curr))
        mix = (pf * np.float32(1 - tf) + cf * np.float32(tf)).astype(
            np.float32)
        want = np.round(np.clip(mix, 0, 1) * np.float32(255)).astype(
            np.uint8).transpose(1, 2, 0)
        np.testing.assert_array_equal(o.view(np.uint8).reshape(want.shape),
                                      want)


@pytest.mark.parametrize("mode", ["pyramid", "exhaustive"])
def test_scene_cut_zeroes_the_next_seed(mode):
    """``return_mv``'s field (the next pair's temporal seed) is all zeros
    across a cut and the field without the detector on the pan (tpufg's
    zeroed seed is held bitwise in the temporal stream below)."""
    kw = dict(mode=mode, factors=[0.25, 0.5, 0.75], dt=torch.bfloat16,
              block_size=8, search_radius=4, return_mv=True)
    for which, pair in _pairs(H, W).items():
        p, c = (frames_to_planar(torch.from_numpy(f)) for f in pair)
        _, mv = pipeline.interp_planar(p, c, scene_cut_threshold=THR, **kw)
        _, free = pipeline.interp_planar(p, c, **kw)
        assert free.abs().max() > 0
        if which == "cut":
            assert not mv.abs().max()
        else:
            np.testing.assert_array_equal(mv.numpy(), free.numpy())


def test_scene_cut_stays_on_the_device():
    """The cut is a 0-d tensor used through torch.where: no host read."""
    p = torch.zeros((4, 8, 8))
    c = torch.ones((4, 8, 8))
    cut = pipeline.scene_cut(p, c, THR)
    assert isinstance(cut, torch.Tensor) and cut.dim() == 0 and bool(cut)
    assert not bool(pipeline.scene_cut(p, p, THR))


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("mode", ["pyramid", "4q", "learned"])
def test_fps_multiplier_matches_tpufg(steps, mode, k):
    """k - 1 in-between frames at t = 1/k .. (k-1)/k, then curr."""
    h, w = (LH, LW) if mode == "learned" else (H, W)
    pair = _pairs(h, w)["no-cut"]
    # at x4 the scene-cut test's steps (no cut on a pan)
    ref, out = _run_pair(steps, mode, k, k == 4, pair)
    assert len(out) == len(ref) == k
    np.testing.assert_array_equal(out[-1], pair[1])
    frac = 0.03 if mode != "learned" else 1e-3
    for o, r in zip(out[:-1], ref[:-1]):
        dd = _diff(o, r)
        assert dd.max() <= 1 and (dd > 0).mean() <= frac
    # distinct time points: no two in-between frames are the same
    assert len({o.tobytes() for o in out[:-1]}) == k - 1


def test_interp_factors():
    cfg = EngineConfig(**_sizes(H, W), interpolation_factor=0.3)
    assert pipeline.interp_factors(cfg) == [0.3]
    cfg.fps_multiplier = 4
    assert pipeline.interp_factors(cfg) == [0.25, 0.5, 0.75]


# ---- the temporal seed -------------------------------------------------

# a horizontal pan that accelerates 10 -> 40 px/frame over three pairs,
# then holds 40 px/frame (twice the unseeded pyramid's ~20 px reach), then
# cuts to unrelated frames (the seed resets).
# tpufg does not lock on a 40 px/frame pan from a zero seed (measured on
# the CPU at 128 x 384: hit rate 0 over 12 pairs); on this one its seeded
# hit rate is 1.0 on every pair and its unseeded one 0.0 from 30 px/frame
# chip_smoke.py holds the card's stream to the same hit tolerance and rates
TH, TW = 128, 384
TRACK_VELOCITY = (10, 20, 30, 40, 40, 40, 40)


@pytest.fixture(scope="module")
def temporal_run():
    """Both packages' temporal x4 step (with --scene-cut) over the
    accelerating pan at identity size and a cut after it, each threading
    its own seed."""
    opts = dict(_sizes(TH, TW), fps_multiplier=4, temporal_mv=True,
                scene_cut_threshold=THR)
    jstep = jpipe.make_interp_step(JConfig(**opts), wire="i32")
    tstep = pipeline.make_interp_step(EngineConfig(**opts), wire="i32",
                                      device=CPU)
    shape = pipeline.mv_lattice_shape(EngineConfig(**opts))
    assert shape == jpipe.mv_lattice_shape(JConfig(**opts))
    frames = track_frames(TH, TW, TRACK_VELOCITY) + [_i32(next(iter(
        SyntheticSource(TW, TH, n_frames=1, pattern="noise", seed=1))))]
    jmv = jnp.zeros(shape, jnp.float32)
    tmv = torch.zeros(shape)
    pairs = []
    for i in range(len(frames) - 1):
        seeds = (np.asarray(jmv), tmv.numpy().copy())
        *ref, jmv = jstep(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1]),
                          jmv)
        *out, tmv = tstep(torch.from_numpy(frames[i]),
                          torch.from_numpy(frames[i + 1]), tmv)
        pairs.append(dict(seeds=seeds, ref=[np.asarray(r) for r in ref],
                          out=[o.numpy() for o in out],
                          jmv=np.asarray(jmv), tmv=tmv.numpy()))
    return jstep, tstep, frames, pairs


def test_temporal_mv_fields_bitwise(temporal_run):
    *_, pairs = temporal_run
    for p in pairs:
        np.testing.assert_array_equal(p["tmv"], p["jmv"])
    assert np.abs(pairs[-2]["tmv"]).max() > 20  # beyond the unseeded reach
    assert not np.abs(pairs[-1]["tmv"]).max()   # reset by the cut


def test_temporal_outputs_match_tpufg(temporal_run):
    _, _, frames, pairs = temporal_run
    for i, p in enumerate(pairs):
        assert len(p["out"]) == len(p["ref"]) == 4
        np.testing.assert_array_equal(p["out"][-1], frames[i + 1])
        if i == len(pairs) - 1:       # the cut: the nearer source
            for o, r, src in zip(p["out"], p["ref"],
                                 (frames[i],) + (frames[i + 1],) * 2):
                np.testing.assert_array_equal(o, src)
                np.testing.assert_array_equal(r, src)
            continue
        for o, r in zip(p["out"][:-1], p["ref"][:-1]):
            dd = _diff(o, r)
            assert dd.max() <= 1 and (dd > 0).mean() <= 0.03


def test_temporal_seed_crosses_packages(temporal_run):
    """The seed is one format: tpufg's mv_out (as numpy) seeds the port's
    step and the port's seeds tpufg's, with the same results."""
    jstep, tstep, frames, pairs = temporal_run
    for i in (1, 4):
        seed = pairs[i]["seeds"][0]          # tpufg's, from pair i - 1
        *out, mv = tstep(torch.from_numpy(frames[i]),
                         torch.from_numpy(frames[i + 1]),
                         torch.from_numpy(seed.copy()))
        np.testing.assert_array_equal(mv.numpy(), pairs[i]["jmv"])
        *ref, jmv = jstep(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1]),
                          jnp.asarray(pairs[i]["seeds"][1]))
        np.testing.assert_array_equal(np.asarray(jmv), pairs[i]["tmv"])
        for o, r in zip(out, pairs[i]["out"]):
            np.testing.assert_array_equal(o.numpy(), r)


def test_temporal_tracking_known_answer(temporal_run):
    """The seeded step tracks the 40 px/frame pan from the 4th pair on;
    the unseeded pyramid does not (its reach is ~20 px)."""
    _, _, frames, pairs = temporal_run
    seeded = [track_hit(torch.from_numpy(p["tmv"]), v)
              for p, v in zip(pairs, TRACK_VELOCITY)]
    assert min(seeded[3:]) >= SEEDED_HIT_MIN, seeded
    for i, v in enumerate(TRACK_VELOCITY):
        if v < 40:
            continue
        _, mv = pipeline.interp_planar(
            *(frames_to_planar(torch.from_numpy(f))
              for f in frames[i:i + 2]), mode="pyramid", factors=[0.5],
            dt=torch.bfloat16, block_size=8, search_radius=16,
            return_mv=True)
        assert track_hit(mv, v) <= UNSEEDED_HIT_MAX


def test_seed_cell_mean_is_xlas_order():
    """The 16-term cell mean of fractional seeds, bitwise to tpufg's
    ``reshape(...).mean((2, 4))`` (a sum in another order differs)."""
    rng = np.random.default_rng(5)
    seed = (rng.standard_normal((2, 20, 28)) * 30).astype(np.float32)
    seed[0, :4, :4] = -0.0                 # the sum starts from +0
    ref = np.asarray(jnp.asarray(seed).reshape(2, 5, 4, 7, 4).mean((2, 4)))
    got = pyramid.seed_cell_mean(torch.from_numpy(seed), 4).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    other = torch.from_numpy(seed).view(2, 5, 4, 7, 4).mean((2, 4)).numpy()
    assert not np.array_equal(other, ref)


def test_seeded_pyramid_matches_tpufg():
    """pyramid_motion_search with a fractional seed (its coarse warp and
    the seeded refine warp lerp), bitwise; the reach check's refusal."""
    from tpufg.models.pyramid import pyramid_motion_search as jpyr
    assert pyramid.TEMPORAL_CLAMP == JTEMPORAL_CLAMP
    h, w = 64, 192
    frames = track_frames(h, w, (24,))
    rng = np.random.default_rng(6)
    seed = (20 + rng.standard_normal((2, h // 16, w // 16)) * 4).astype(
        np.float32)
    jp_, jc_ = (jpipe.frames_to_planar(jnp.asarray(f), jnp.float32)
                for f in frames)
    ref = jpyr(jp_, jc_, levels=3, skip_finest_refine=1,
               seed=jnp.asarray(seed))
    got = pyramid.pyramid_motion_search(
        *(frames_to_planar(torch.from_numpy(f)) for f in frames), levels=3,
        skip_finest_refine=1, seed=torch.from_numpy(seed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="halo range"):
        pyramid.pyramid_motion_search(
            *(frames_to_planar(torch.from_numpy(f)) for f in frames),
            levels=3, skip_finest_refine=0, seed=torch.from_numpy(seed))


def test_4q_with_temporal_mv_runs():
    """The quality preset with the temporal seed (tpufg's
    test_subpel_with_temporal_mv_traces): the sub-pel probes at the
    seeded reach (72, probed at 54), two pairs with the seed threaded."""
    cfg = EngineConfig(**_sizes(H, W), temporal_mv=True, fps_multiplier=3,
                       **Q)
    step = pipeline.make_interp_step(cfg, wire="i32", device=CPU)
    frames = [torch.from_numpy(f) for f in track_frames(H, W, (6, 9))]
    mv = torch.zeros(pipeline.mv_lattice_shape(cfg))
    for i in range(2):
        *outs, nxt = step(frames[i], frames[i + 1], mv)
        assert len(outs) == 3 and nxt.shape == mv.shape and nxt is not mv
        assert bool(torch.isfinite(nxt).all()) and nxt.abs().max() > 0
        np.testing.assert_array_equal(outs[-1].numpy(), frames[i + 1].numpy())
        mv = nxt


# ---- the y4m egress ----------------------------------------------------

@pytest.mark.parametrize("chroma", ["420", "444"])
@pytest.mark.parametrize("hw", [(16, 24), (8, 6), (12, 130)])
def test_y4m_payload_bitwise(chroma, hw):
    """The plain version (the kernel's twin) against tpufg's payload and
    the host egress of io/sinks.py, from the int32 wire and from uint8."""
    h, w = hw
    if not yuv.y4m_wire_ok(h, w, chroma):
        with pytest.raises(ValueError):
            yuv.rgba_to_y4m_payload(torch.zeros((h, w), dtype=torch.int32),
                                    chroma)
        return
    rng = np.random.default_rng(h * w)
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[0, :4] = [[0, 0, 0, 0], [255, 255, 255, 255], [255, 0, 0, 9],
                [0, 0, 255, 200]]
    ref = np.asarray(jyuv.rgba_to_y4m_payload(jnp.asarray(_i32(f)),
                                              chroma=chroma))
    got = yuv.rgba_to_y4m_payload(torch.from_numpy(_i32(f)), chroma).numpy()
    got_u8 = yuv.rgba_to_y4m_payload(torch.from_numpy(f), chroma).numpy()
    y, u, v = _rgb_to_bt601(f[..., :3])
    if chroma == "420":
        u, v = _down2x2(u), _down2x2(v)
    host = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_u8, ref)
    np.testing.assert_array_equal(got.ravel(), host)


def test_y4m_extreme_codes():
    """Every code on each channel with the others at 0 and 255: the clip
    at both ends and the arithmetic shift of negative chroma sums."""
    codes = np.arange(256, dtype=np.uint8)
    rows = []
    for c in range(3):
        for other in (0, 255):
            f = np.full((256, 4), other, np.uint8)
            f[:, c] = codes
            rows.append(f)
    f = np.stack(rows).reshape(24, 64, 4)
    for chroma in ("420", "444"):
        ref = np.asarray(jyuv.rgba_to_y4m_payload(jnp.asarray(f),
                                                  chroma=chroma))
        got = yuv.rgba_to_y4m_payload_plain(torch.from_numpy(f), chroma)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw,chroma", [((2160, 3840), "420"),
                                       ((1080, 1920), "444"),
                                       ((270, 480), "420"), ((5, 7), "444"),
                                       ((6, 8), "420")])
def test_payload_shape_and_wire_ok(hw, chroma):
    assert yuv.payload_shape(*hw, chroma) == jyuv.payload_shape(*hw, chroma)
    assert yuv.y4m_wire_ok(*hw, chroma) == jyuv.y4m_wire_ok(*hw, chroma)


def test_steps_emit_y4m_payloads():
    """sink_wire y4m420: every output (curr's passthrough included) is its
    payload, byte for byte the RGBA step's output through the host
    egress; an unknown sink wire raises ValueError."""
    cfg = EngineConfig(**_sizes(H, W, 2 * H, 2 * W), fps_multiplier=3)
    pair = [torch.from_numpy(f) for f in _pairs(H, W)["no-cut"]]
    rgba = pipeline.make_interp_step(cfg, wire="i32", device=CPU)(*pair)
    for wire in ("i32", "u8"):
        frames = (pair if wire == "i32" else
                  [f.view(torch.uint8).reshape(H, W, 4) for f in pair])
        outs = pipeline.make_interp_step(cfg, wire=wire, sink_wire="y4m420",
                                         device=CPU)(*frames)
        assert len(outs) == 3
        for o, r in zip(outs, rgba):
            np.testing.assert_array_equal(
                o.numpy(), yuv.rgba_to_y4m_payload(r, "420").numpy())
    ident = EngineConfig(**_sizes(H, W))
    out = pipeline.make_scale_step(ident, wire="i32", sink_wire="y4m444",
                                   device=CPU)(pair[0])
    np.testing.assert_array_equal(
        out.numpy(), yuv.rgba_to_y4m_payload(pair[0], "444").numpy())
    with pytest.raises(ValueError, match="sink wire"):
        pipeline.make_scale_step(ident, sink_wire="nv12", device=CPU)


# ---- the engine --------------------------------------------------------

def _y4m_frames(path):
    data = path.read_bytes()
    header, _, body = data.partition(b"\n")
    return header, body.split(b"FRAME\n")[1:]


def test_engine_x4_temporal_y4m_matches_tpufg(tmp_path):
    """StreamingEngine.run at x4 with --temporal-mv and --scene-cut into a
    C420 y4m file: the same header and frame count as tpufg's runner, each
    payload within 1 code of its (the in-between frames' contract), the
    curr frames byte for byte; and the device egress's file equal to the
    host egress's (the overlay forces the RGBA wire; here the engine is
    rebuilt with the y4m wire refused)."""
    opts = dict(_sizes(H, W), fps_multiplier=4, temporal_mv=True,
                scene_cut_threshold=THR, target_fps=30)
    paths = {k: tmp_path / f"{k}.y4m" for k in ("tpufg", "port", "host")}

    def source():
        return SyntheticSource(W, H, n_frames=3, velocity=(8.0, 4.0))

    with JY4MSink(str(paths["tpufg"]), W, H, 120.0, chroma="420") as s:
        jstats = jrun_stream(JConfig(**opts), source(), s, paced=False)
    with Y4MSink(str(paths["port"]), W, H, 120.0, chroma="420") as s:
        stats = run_stream(EngineConfig(**opts), source(), s, paced=False,
                           device=CPU)
    engine = StreamingEngine(EngineConfig(**opts), device=CPU)
    engine._sink_wire = lambda sink: "rgba"
    with Y4MSink(str(paths["host"]), W, H, 120.0, chroma="420") as s:
        engine.run(source(), s, paced=False)
    assert stats.frames_in == jstats.frames_in == 3
    assert stats.frames_out == jstats.frames_out == 9
    assert paths["port"].read_bytes() == paths["host"].read_bytes()
    jh, jf = _y4m_frames(paths["tpufg"])
    th, tf = _y4m_frames(paths["port"])
    assert th == jh and len(tf) == len(jf) == 9
    for i, (a, b) in enumerate(zip(tf, jf)):
        dd = _diff(np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8))
        assert dd.max() <= 1 and (dd > 0).mean() <= 0.03
        if i % 4 == 0:
            assert a == b          # the scaled first frame and each curr


def test_engine_sink_wire_negotiation(tmp_path):
    cfg = EngineConfig(**_sizes(H, W))
    engine = StreamingEngine(cfg, device=CPU)
    sink = Y4MSink(str(tmp_path / "a.y4m"), W, H, chroma="420")
    assert engine._sink_wire(sink) == "y4m420"
    sink.close()
    odd = StreamingEngine(EngineConfig(**_sizes(H, W, 66, 128)), device=CPU)
    sink = Y4MSink(str(tmp_path / "b.y4m"), 128, 66, chroma="420")
    assert odd._sink_wire(sink) == "rgba"          # 66 % 4 != 0
    sink.close()
    over = StreamingEngine(EngineConfig(**_sizes(H, W), overlay=True),
                           device=CPU)
    sink = Y4MSink(str(tmp_path / "c.y4m"), W, H, chroma="444")
    assert over._sink_wire(sink) == "rgba"
    sink.close()


@pytest.mark.parametrize("temporal", [False, True])
def test_step_rates_on_cpu(temporal):
    """measure_step_rate threads the seed where cfg asks for it."""
    from tpufg_torch.engine.runner import measure_step_rate
    cfg = EngineConfig(**_sizes(H, W), temporal_mv=temporal,
                       fps_multiplier=3)
    assert measure_step_rate(cfg, n=2, device=CPU) > 0.0
