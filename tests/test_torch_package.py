"""The port's packaging contract: no JAX and nothing of tpufg, loud
refusals, no silent CPU."""

import ast
import json
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufg_torch import cli
from tpufg_torch.cli import build_parser
from tpufg_torch.config import (EngineConfig, apply_quality_preset,
                                resolve_sizes)
from tpufg_torch.io.preview import PreviewSink, TeeSink, parse_preview_spec
from tpufg_torch.io.sinks import NullSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.engine import pipeline
from tpufg_torch.engine.runner import StreamingEngine
from tpufg_torch.models import rife

REPO = Path(__file__).resolve().parent.parent


def test_importing_every_module_leaves_jax_out():
    """Importing every module of the port (and the CLI's entry point)
    loads neither jax nor any module of tpufg."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpufg_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpufg_torch.__path__, 'tpufg_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 22, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'tpufg')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(source: str) -> set[str]:
    """The top-level package of every import statement in a module's
    source, at any depth (lazy imports inside functions included)."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_tpufg_or_jax():
    files = sorted((REPO / "tpufg_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 25
    bad = {str(f.relative_to(REPO)): sorted(
        _imported_roots(f.read_text()) & {"tpufg", "jax", "jaxlib"})
        for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the walk sees lazy imports, such as a function-level import of
    # tpufg's pacing clock
    assert _imported_roots("def f():\n    import os\n"
                           "    from tpufg.io.native import NativeClock\n"
                           ) == {"os", "tpufg"}


UNPORTED_FLAGS = [
    # a v1 and a v2 head: loaded, then refused by name
    ["--motion-mode", "learned", "--model-path",
     str(REPO / "checkpoints" / "head64.npz")],
    ["--motion-mode", "learned", "--model-path",
     str(REPO / "checkpoints" / "head64_v2.npz")],
    ["--devices", "4"],
]


@pytest.mark.parametrize("flags", UNPORTED_FLAGS,
                         ids=[" ".join(f) for f in UNPORTED_FLAGS])
def test_unported_flag_raises(flags):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(["synthetic:64x64", "--frames", "2", "--no-pacing", *flags])


PORTED_FLAGS = [
    ["--motion-mode", "exhaustive"],
    ["--motion-mode", "learned"],
    ["--interpolation-factor", "0.25"],
    ["--search-radius", "9"],
    ["--block-size", "12"],
    # the quality preset's flags, and the preset itself (config 4q)
    ["--mv-grid", "8"],
    ["--mv-grid", "1"],
    ["--subpel"],
    ["--mv-filter"],
    ["--occlusion-blend"],
    ["--mc-fallback"],
    ["--quality"],
    # the streaming engine's options
    ["--scene-cut", "0.1"],
    ["--temporal-mv"],
    ["--overlay"],
    ["--fps-multiplier", "4"],
    ["--fps-multiplier", "3", "--motion-mode", "learned"],
    ["--temporal-mv", "--fps-multiplier", "4", "--scene-cut", "0.1"],
    # the exact precision path and the run's tracing and NaN guard
    ["--precision", "exact"],
    ["--precision", "exact", "--fps-multiplier", "3", "--motion-mode",
     "none"],
    ["--trace", "trace_dir"],
    ["--debug-checks"],
]


@pytest.mark.parametrize("flags", PORTED_FLAGS,
                         ids=[" ".join(f) for f in PORTED_FLAGS])
def test_ported_flag_runs_on_cpu_step(flags):
    """Flags of the ported slices: accepted, and the CPU step returns the
    k - 1 in-between frames and curr at the output size (the learned step
    with the bundled head, as the CLI loads it); with --temporal-mv the
    step takes the MV seed and returns the next one after the frames; the
    exact step speaks uint8 frames."""
    args = build_parser().parse_args(["synthetic:64x64", *flags])
    cfg = resolve_sizes(cli._config(args), detected_input=(64, 64))
    if args.quality:
        cfg = apply_quality_preset(cfg)
        assert (cfg.mv_grid, cfg.subpel, cfg.mc_fallback) == (1, True, True)
    params = (rife.load_params(rife.bundled_checkpoint())
              if args.motion_mode == "learned" else None)
    assert pipeline.unported_settings(cfg, args.precision, params) == []
    assert cli._unported_flags(args) == []
    exact = args.precision == "exact"
    frames = [torch.from_numpy(f if exact else
                                f.view(np.int32).reshape(64, 64))
              for f in SyntheticSource(64, 64, n_frames=2)]
    step = pipeline.make_interp_step(cfg, args.precision,
                                     wire="u8" if exact else "i32",
                                     device="cpu", model_params=params)
    if args.temporal_mv:
        seed = torch.zeros(pipeline.mv_lattice_shape(cfg))
        *outs, mv = step(*frames, seed)
        assert mv.shape == seed.shape and mv is not seed
    else:
        outs = step(*frames)
    assert len(outs) == args.fps_multiplier
    for o in outs:
        assert ((o.dtype, tuple(o.shape)) == (torch.uint8, (64, 64, 4))
                if exact else
                (o.dtype, tuple(o.shape)) == (torch.int32, (64, 64)))


def test_unported_config_raises_in_builders():
    cfg = EngineConfig(input_width=64, input_height=64, output_width=128,
                       output_height=128)
    # the exact path is ported; an unknown precision is refused
    assert pipeline.make_interp_step(cfg, precision="exact", device="cpu")
    assert StreamingEngine(cfg, precision="exact", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        StreamingEngine(cfg, precision="fastest", device="cpu")
    learned = EngineConfig(input_width=64, input_height=64, output_width=64,
                           output_height=64, motion_mode="learned")
    v1 = rife.load_params(str(REPO / "checkpoints" / "head64.npz"))
    with pytest.raises(NotImplementedError, match="head"):
        pipeline.make_interp_step(learned, device="cpu", model_params=v1)
    with pytest.raises(NotImplementedError, match="head"):
        StreamingEngine(learned, device="cpu", model_params=v1)
    # the y4m sink wires are ported; an unknown wire is refused
    assert pipeline.make_scale_step(cfg, sink_wire="y4m420", device="cpu")
    with pytest.raises(ValueError, match="sink wire"):
        pipeline.make_scale_step(cfg, sink_wire="yuyv", device="cpu")


def test_preview_flag_is_ported():
    args = build_parser().parse_args(["synthetic:64x64", "--preview",
                                      "8080"])
    assert cli._unported_flags(args) == []
    args = build_parser().parse_args(["synthetic:64x64", "--trace", "t",
                                      "--debug-checks", "--devices", "2"])
    assert cli._unported_flags(args) == ["--devices"]


def test_default_device_refuses_to_fall_back_to_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    cfg = EngineConfig(input_width=64, input_height=64, output_width=128,
                       output_height=128)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_interp_step(cfg)
    sink = NullSink()
    rc = cli.main(["synthetic:64x64", "--frames", "2", "--no-pacing"])
    assert rc == 1
    assert "needs a CUDA device" in capsys.readouterr().out
    # the explicit CPU device runs
    stats = StreamingEngine(cfg, device="cpu").run(
        SyntheticSource(64, 64, n_frames=3), sink, paced=False)
    assert stats.frames_out == 5 == sink.count


def test_plain_versions_switch_is_scoped():
    """``kernels.common.plain_versions``: a CUDA tensor takes the plain
    version inside it only.  It nests, is off again after a normal exit and
    after an exception, and another thread does not see it; a CPU tensor
    takes the plain version always, another device is refused."""
    from types import SimpleNamespace
    from tpufg_torch.kernels.common import plain_versions, use_plain
    card = SimpleNamespace(device=torch.device("cuda", 0))
    assert use_plain(torch.zeros(1)) and not use_plain(card)
    seen = []
    with plain_versions():
        assert use_plain(card)
        with plain_versions():
            assert use_plain(card)
        assert use_plain(card)
        t = threading.Thread(target=lambda: seen.append(use_plain(card)))
        t.start()
        t.join()
    assert seen == [False]
    assert not use_plain(card)
    with pytest.raises(ZeroDivisionError):
        with plain_versions():
            assert use_plain(card)
            _ = 1 / 0
    assert not use_plain(card) and use_plain(torch.zeros(1))
    with pytest.raises(ValueError, match="cpu or cuda"):
        use_plain(torch.zeros(1, device="meta"))


# ---- the live preview (--preview): tpufg's tests/test_preview.py cases
# against the port's copy (io/preview.py); the servers bind to loopback on
# an ephemeral port

def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _png_size(body):
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", body[16:24])


def _rgba(i, h=24, w=32):
    f = np.zeros((h, w, 4), np.uint8)
    f[..., 0] = i
    f[..., 3] = 255
    return f


@pytest.mark.parametrize("spec,want", [("8000", ("127.0.0.1", 8000)),
                                       ("0.0.0.0:81", ("0.0.0.0", 81))])
def test_preview_spec(spec, want):
    assert parse_preview_spec(spec) == want


@pytest.mark.parametrize("bad", ["", "eight", "1.2.3.4", "x:y:1"])
def test_preview_spec_refuses(bad):
    with pytest.raises(ValueError):
        parse_preview_spec(bad)


def test_preview_serves_latest_frame_and_stats():
    with PreviewSink(0) as sink:
        base = sink.url
        st = json.loads(_get(base + "stats.json")[2])
        assert st == {"frames": 0, "width": 0, "height": 0, "fps": 0.0}
        sink.write(_rgba(7))
        sink.write(_rgba(9))
        status, headers, body = _get(base + "frame.png")
        assert status == 200 and headers["X-Frame-Index"] == "1"
        assert _png_size(body) == (32, 24)
        raw = zlib.decompress(body[41:-16])  # strip IDAT crc + IEND
        assert raw[1] == 9   # the latest frame's first R, after the filter
        st = json.loads(_get(base + "stats.json")[2])
        assert st["frames"] == 2 and (st["width"], st["height"]) == (32, 24)


def test_preview_long_poll_wakes_on_write():
    with PreviewSink(0) as sink:
        sink.write(_rgba(1))
        got = {}

        def poll():
            got["r"] = _get(sink.url + "frame.png?after=0")

        t = threading.Thread(target=poll)
        t.start()
        time.sleep(0.2)          # the poller waits on the condition
        sink.write(_rgba(2))
        t.join(timeout=5)
        assert not t.is_alive()
        status, headers, _ = got["r"]
        assert status == 200 and headers["X-Frame-Index"] == "1"


def test_preview_down_decimates():
    with PreviewSink(0) as sink:
        sink.write(_rgba(3, h=24, w=32))
        assert _png_size(_get(sink.url + "frame.png?down=2")[2]) == (16, 12)


def test_preview_unknown_path_404():
    with PreviewSink(0) as sink:
        sink.write(_rgba(0))
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(sink.url + "nope")
        assert e.value.code == 404


def test_tee_fans_out_and_forces_rgba_wire():
    a, b = NullSink(), NullSink()
    tee = TeeSink(a, b)
    assert tee.wire_format == "rgba" and tee.needs_host is False
    tee.write(_rgba(0))
    assert a.count == 1 and b.count == 1
    with PreviewSink(0) as p:
        assert TeeSink(NullSink(), p).needs_host is True


def _cli_on_cpu(monkeypatch, argv):
    """The command line with the CPU as its device (it refuses the CPU
    otherwise): (exit code, stats)."""
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "cpu")
    return cli.run(argv)


def test_cli_preview_serves_the_stream(monkeypatch):
    made = {}

    def capture(port, host="127.0.0.1"):
        made["sink"] = PreviewSink(port, host)
        return made["sink"]

    monkeypatch.setattr(cli, "PreviewSink", capture)
    rc, stats = _cli_on_cpu(monkeypatch, [
        "synthetic:32x32", "--frames", "3", "--no-pacing", "--motion-mode",
        "none", "--output", "null", "--dtype", "f32", "--preview",
        "127.0.0.1:0"])
    assert rc == 0 and stats.frames_out == 5
    assert made["sink"]._index + 1 == 5  # 1 + 2 * 2 crossfade outputs


def test_cli_preview_bad_spec_exits_one(monkeypatch):
    rc, _ = _cli_on_cpu(monkeypatch, [
        "synthetic:16x16", "--frames", "2", "--no-pacing", "--output",
        "null", "--preview", "not-a-port"])
    assert rc == 1


def test_cli_engine_options_run_on_cpu(monkeypatch, tmp_path):
    """x4 with the temporal seed, the scene cut and the overlay into a
    y4m file: 4 frames in, 13 out, the header's rate 4x the input's."""
    out = tmp_path / "o.y4m"
    rc, stats = _cli_on_cpu(monkeypatch, [
        "synthetic:64x64", "--frames", "4", "--no-pacing",
        "--fps-multiplier", "4", "--temporal-mv", "--scene-cut", "0.1",
        "--overlay", "--target-fps", "30", "--output", str(out),
        "--y4m-chroma", "420"])
    assert rc == 0 and (stats.frames_in, stats.frames_out) == (4, 13)
    data = out.read_bytes()
    assert data.startswith(b"YUV4MPEG2 W64 H64 F120000:1000 ")
    assert data.count(b"FRAME\n") == 13
