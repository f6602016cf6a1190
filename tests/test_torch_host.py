"""The port's own host modules against tpufg's (CPU): parser, config,
sources, sinks, the native ingest library, stats, the logger, the stats
overlay, the live preview's address parser and the quality metrics.

The port keeps copies of tpufg's JAX-free host modules so that it imports
nothing of tpufg; these tests hold each copy to its original.  The port's
own additions (``learned_scale`` and ``--learned-scale``, RIFE's IFNet,
which tpufg does not have) are left out of each comparison and checked on
their own.  Tolerance:
exact everywhere (equal parsed namespaces and parser actions, equal
configs and errors, bitwise frames, byte-equal files, equal stats and
log lines, equal SSIM and PSNR values and errors).
"""

import dataclasses
import io
import re

import numpy as np
import pytest

import tpufg.cli as jcli
import tpufg.config as jconfig
from tpufg.engine import overlay as joverlay
from tpufg.io import native as jnative
from tpufg.io import preview as jpreview
from tpufg.io import sinks as jsinks
from tpufg.io import sources as jsources
from tpufg.utils import logging as jlogging
from tpufg.utils import quality as jquality
from tpufg.utils import stats as jstats
from tpufg_torch import cli, config
from tpufg_torch.engine import overlay
from tpufg_torch.io import native, preview, sinks, sources
from tpufg_torch.utils import logging, quality, stats

ARGVS = [
    [],
    ["synthetic:64x64"],
    ["in.raw", "--input-width", "320", "--input-height", "240",
     "--output-width", "640", "--channel-order", "bgra"],
    ["synthetic:1920x1080", "--output-width", "3840", "--output-height",
     "2160", "--frames", "48", "--no-pacing", "--output", "null"],
    ["clip.y4m", "--motion-mode", "exhaustive", "--block-size", "16",
     "--search-radius", "9", "--interpolation-factor", "0.25"],
    ["clip.mp4", "--motion-mode", "learned", "--model-path", "h.npz",
     "--dtype", "f32", "--precision", "exact", "--lanczos-a", "2"],
    ["-", "--output", "-", "--y4m-chroma", "420", "--target-fps", "30",
     "--start-frame", "5", "--fps-multiplier", "4"],
    ["x", "--mv-grid", "1", "--subpel", "--mv-bias", "0.1", "--mv-filter",
     "--occlusion-blend", "--mc-fallback", "--scene-cut", "0.1",
     "--temporal-mv"],
    ["x", "--quality"],
    ["x", "--quality", "auto", "--devices", "4", "--dp", "2", "--overlay",
     "--trace", "t/", "--debug-checks", "--preview", "8080",
     "--no-interpolation"],
]


# the port's own config field and flag, with their defaults
PORT_ONLY = {"learned_scale": 1.0}


def _shared(d: dict) -> dict:
    """``d`` without the port's own fields, which hold their defaults."""
    d = dict(d)
    for k, v in PORT_ONLY.items():
        assert d.pop(k) == v, k
    return d


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "(none)"
                                              for a in ARGVS])
def test_parsers_give_equal_namespaces(argv):
    assert (_shared(vars(cli.build_parser().parse_args(argv)))
            == vars(jcli.build_parser().parse_args(argv)))


def test_parsers_have_equal_actions():
    def actions(p):
        return sorted((tuple(a.option_strings), a.dest, a.default, a.const,
                       None if a.choices is None else tuple(a.choices),
                       a.nargs, a.type, a.metavar, type(a).__name__)
                      for a in p._actions)

    ours, theirs = cli.build_parser(), jcli.build_parser()
    own = [a for a in ours._actions if a.dest in PORT_ONLY]
    assert [(a.option_strings, a.default, a.choices) for a in own] == [
        (["--learned-scale"], 1.0, [0.25, 0.5, 1.0, 2.0, 4.0])]
    shared = [a for a in ours._actions if a.dest not in PORT_ONLY]
    ours._actions = shared
    assert actions(ours) == actions(theirs)
    assert ({s for a in ours._actions for s in a.option_strings}
            == {s for a in theirs._actions for s in a.option_strings})
    assert ours.prog == "python -m tpufg_torch.cli"
    for a in ours._actions:
        assert "TPU" not in (a.help or "") and "jax" not in (a.help or "")


def test_engine_config_defaults_and_fields_agree():
    fields = [(f.name, f.default) for f in dataclasses.fields(
        config.EngineConfig)]
    assert [f for f in fields if f[0] in PORT_ONLY] == list(PORT_ONLY.items())
    assert ([f for f in fields if f[0] not in PORT_ONLY]
            == [(f.name, f.default) for f in
                dataclasses.fields(jconfig.EngineConfig)])


BAD = [dict(interpolation_factor=1.5), dict(target_fps=0), dict(dtype="f16"),
       dict(motion_mode="flow"), dict(block_size=0), dict(search_radius=-1),
       dict(fps_multiplier=1), dict(mv_grid=4), dict(mv_bias=-0.1),
       dict(scene_cut_threshold=1.0), dict(temporal_mv=True,
                                           motion_mode="exhaustive"),
       dict(search_radius=120), dict(temporal_mv=True, fps_multiplier=8),
       dict(output_width=-1)]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_validate_refuses_alike(kw):
    with pytest.raises(jconfig.ConfigError) as theirs:
        jconfig.EngineConfig(**kw).validate()
    with pytest.raises(config.ConfigError) as ours:
        config.EngineConfig(**kw).validate()
    assert str(ours.value) == str(theirs.value)
    assert issubclass(config.ConfigError, ValueError)


SIZES = [(dict(), (1920, 1080)), (dict(output_width=3840), (1920, 1080)),
         (dict(output_height=2160), (1280, 720)),
         (dict(input_width=640, input_height=480, output_width=1000), None),
         (dict(input_width=333, input_height=111, output_height=50), None),
         (dict(), None), (dict(input_width=64, input_height=64,
                               output_width=1), None)]


@pytest.mark.parametrize("kw,detected", SIZES,
                         ids=[f"{k}-{d}" for k, d in SIZES])
def test_resolve_sizes_and_preset_agree(kw, detected):
    def run(mod):
        try:
            cfg = mod.resolve_sizes(mod.EngineConfig(**kw), detected)
        except mod.ConfigError as e:
            return "error", str(e)
        return (dataclasses.asdict(cfg),
                dataclasses.asdict(mod.apply_quality_preset(
                    cfg, frozenset({"mv_bias"}))))

    ours = run(config)
    if ours[0] != "error":
        ours = tuple(_shared(d) for d in ours)
    assert ours == run(jconfig)


@pytest.mark.parametrize("pattern", ["pan", "panmix", "noise", "gradient"])
def test_synthetic_frames_bitwise(pattern):
    ours = sources.SyntheticSource(48, 32, n_frames=6, pattern=pattern,
                                   seed=3)
    theirs = jsources.SyntheticSource(48, 32, n_frames=6, pattern=pattern,
                                      seed=3)
    assert ours.size == theirs.size and ours.fps == theirs.fps
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    spec = f"synthetic:48x32:{pattern}"
    np.testing.assert_array_equal(
        next(iter(sources.open_source(spec, frames=2))),
        next(iter(jsources.open_source(spec, frames=2))))


def _frames(seed, n=3, h=16, w=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("chroma", ["444", "420"])
def test_y4m_sink_bytes_and_read_back(tmp_path, chroma):
    frames = _frames(4)
    paths = {}
    for name, mod in (("ours", sinks), ("theirs", jsinks)):
        paths[name] = tmp_path / f"{name}.y4m"
        with mod.open_sink(str(paths[name]), 24, 16, fps=30.0,
                           y4m_chroma=chroma) as sink:
            for f in frames:
                sink.write(f)
    assert paths["ours"].read_bytes() == paths["theirs"].read_bytes()
    got = list(sources.open_source(str(paths["ours"])))
    want = list(jsources.open_source(str(paths["ours"])))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", ["rgba", "bgra"])
def test_raw_sink_bytes_and_read_back(tmp_path, order):
    frames = _frames(5)
    path = tmp_path / "ours.raw"
    sink = sinks.AsyncSink(sinks.open_sink(str(path), 24, 16))
    for f in frames:
        sink.write(f)
    sink.close()
    assert path.read_bytes() == b"".join(f.tobytes() for f in frames)
    for ours, theirs in (
            (sources.open_source(str(path), 24, 16, order),
             jsources.open_source(str(path), 24, 16, order)),
            (sources.RawVideoSource(str(path), 24, 16, order),
             jsources.RawVideoSource(str(path), 24, 16, order))):
        assert ours.const_alpha == theirs.const_alpha
        got = [f.copy() for f in ours]
        want = [f.copy() for f in theirs]
        ours.close()
        theirs.close()
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_png_sink_bytes(tmp_path):
    frame = _frames(6, n=1)[0]
    assert sinks.encode_png(frame) == jsinks.encode_png(frame)
    for name, mod in (("ours", sinks), ("theirs", jsinks)):
        with mod.open_sink(str(tmp_path / name) + "/", 24, 16) as sink:
            sink.write(frame)
    assert ((tmp_path / "ours" / "frame_000000.png").read_bytes()
            == (tmp_path / "theirs" / "frame_000000.png").read_bytes())


def test_native_conversions_agree():
    assert native.available() == jnative.available()
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (17, 33, 4), dtype=np.uint8)
    np.testing.assert_array_equal(native.bgra_to_rgba(src),
                                  jnative.bgra_to_rgba(src))
    y = rng.integers(16, 236, (8, 12), dtype=np.uint8)
    for cw in (12, 6):        # 444 and 420 chroma planes
        u = rng.integers(16, 240, (8 * cw // 12, cw), dtype=np.uint8)
        v = rng.integers(16, 240, (8 * cw // 12, cw), dtype=np.uint8)
        a, b = native.yuv_to_rgba(y, u, v), jnative.yuv_to_rgba(y, u, v)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


def test_native_library_builds_inside_the_port():
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain: the pure-python paths run instead")
    from pathlib import Path
    lib = Path(native._SO_PATH)
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.parent.parent == Path(cli.__file__).resolve().parent


STAT_RUNS = [(4, [0.0, 0.016, 0.033, 0.05, 0.066, 0.1]),
             (60, list(np.cumsum(np.random.default_rng(8).uniform(
                 0.001, 0.03, 150)))),
             (3, [1.0]), (2, [5.0, 5.0, 5.0])]


@pytest.mark.parametrize("window,ticks", STAT_RUNS,
                         ids=[f"w{w}-n{len(t)}" for w, t in STAT_RUNS])
def test_stats_agree(window, ticks):
    ours, theirs = stats.FpsWindow(window), jstats.FpsWindow(window)
    lat, jlat = stats.LatencyRecorder(capacity=50), jstats.LatencyRecorder(
        capacity=50)
    assert lat.summary() == jlat.summary()
    for prev_t, t in zip([ticks[0]] + ticks[:-1], ticks):
        for fps in (ours, theirs):
            fps.tick(t)
        for rec in (lat, jlat):
            rec.record(t - prev_t + 1e-3 * (t % 0.007))
        assert ours.fps == theirs.fps
    assert len(lat) == len(jlat)
    assert lat.summary() == jlat.summary()
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert lat.percentile(q) == jlat.percentile(q)
    with pytest.raises(ValueError) as mine:
        stats.FpsWindow(1)
    with pytest.raises(ValueError) as ref:
        jstats.FpsWindow(1)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("level", ["DEBUG", "INFO", "WARNING", "ERROR"])
def test_loggers_write_alike(level):
    def run(mod):
        out = io.StringIO()
        log = mod.Logger(mod.LogLevel[level], stream=out)
        assert not log.has_error()
        log.debug("d", 1)
        log.info("i ", 2.5)
        log.warning("w")
        log.error("e", "!", 3)
        log.info("after")
        latch = (log.has_error(), log.get_last_error())
        log.clear_error()
        # the timestamp is the wall clock: compare what follows it
        lines = [re.sub(r"^\[[^]]*\] ", "", ln)
                 for ln in out.getvalue().splitlines()]
        return lines, latch, log.has_error(), int(mod.LogLevel[level])

    assert run(logging) == run(jlogging)
    assert isinstance(logging.get_logger(), logging.Logger)
    assert logging.get_logger() is logging.get_logger()


OVERLAYS = [(7.5, (1920, 1080), (3840, 2160)), (123.456, (64, 48), (128, 96)),
            (0.0, (5, 7), (9, 11))]


@pytest.mark.parametrize("fps,in_wh,out_wh", OVERLAYS,
                         ids=[f"{o[0]}" for o in OVERLAYS])
def test_overlays_draw_alike(fps, in_wh, out_wh):
    """``draw_stats`` on the same frame, in place, byte for byte (a frame
    narrower than the line clips it alike); ``render_text``'s mask too."""
    rng = np.random.default_rng(int(fps))
    for h, w in ((40, 400), (12, 30)):
        frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        a, b = frame.copy(), frame.copy()
        ra = overlay.draw_stats(a, fps, in_wh, out_wh)
        rb = joverlay.draw_stats(b, fps, in_wh, out_wh)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(ra, frame)
    text = f"FPS: {fps:.1f}  Input: 1x2 ~?"
    for scale in (1, 2):
        np.testing.assert_array_equal(overlay.render_text(text, scale),
                                      joverlay.render_text(text, scale))


@pytest.mark.parametrize("spec", ["8000", "0.0.0.0:81", "localhost:0",
                                  " 9 ", "", "eight", "1.2.3.4", "x:y:1"])
def test_preview_specs_parse_alike(spec):
    try:
        want = jpreview.parse_preview_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as mine:
            preview.parse_preview_spec(spec)
        assert str(mine.value) == str(e)
        return
    assert preview.parse_preview_spec(spec) == want


QUALITY = [((32, 40, 4), 0.05), ((16, 16), 0.3), ((11, 11, 3), 1.0),
           ((24, 24, 4), 0.0)]


@pytest.mark.parametrize("shape,noise", QUALITY,
                         ids=[f"{q[0]}-{q[1]}" for q in QUALITY])
def test_quality_metrics_agree(shape, noise):
    """``ssim`` and ``psnr`` of the same images, to the bit (identical
    images: SSIM 1 and PSNR inf alike)."""
    rng = np.random.default_rng(len(shape) + int(noise * 100))
    a = rng.random(shape)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1)
    assert quality.ssim(a, b) == jquality.ssim(a, b)
    assert quality.psnr(a, b) == jquality.psnr(a, b)
    assert quality.ssim(a, b, 2.0) == jquality.ssim(a, b, 2.0)


@pytest.mark.parametrize("a,b", [((8, 8), (8, 8)), ((12, 12), (12, 13))],
                         ids=["too_small", "mismatch"])
def test_quality_metrics_refuse_alike(a, b):
    x, y = np.zeros(a), np.zeros(b)
    with pytest.raises(ValueError) as ref:
        jquality.ssim(x, y)
    with pytest.raises(ValueError) as mine:
        quality.ssim(x, y)
    assert str(mine.value) == str(ref.value)
