"""The port's packaging contract: no JAX and nothing of tpufg, loud
refusals, no silent CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufg_torch import cli
from tpufg_torch.cli import build_parser
from tpufg_torch.config import (EngineConfig, apply_quality_preset,
                                resolve_sizes)
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
    ["--precision", "exact"],
    # a v1 head: loaded, then refused by name
    ["--motion-mode", "learned", "--model-path",
     str(REPO / "checkpoints" / "head64.npz")],
    ["--scene-cut", "0.1"],
    ["--temporal-mv"],
    ["--overlay"],
    ["--devices", "4"],
    ["--fps-multiplier", "4"],
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
]


@pytest.mark.parametrize("flags", PORTED_FLAGS,
                         ids=[" ".join(f) for f in PORTED_FLAGS])
def test_ported_flag_runs_on_cpu_step(flags):
    """Flags of the ported slices: accepted, and the CPU step returns the
    in-between frame and curr at the output size (the learned step with
    the bundled head, as the CLI loads it)."""
    args = build_parser().parse_args(["synthetic:64x64", *flags])
    cfg = resolve_sizes(cli._config(args), detected_input=(64, 64))
    if args.quality:
        cfg = apply_quality_preset(cfg)
        assert (cfg.mv_grid, cfg.subpel, cfg.mc_fallback) == (1, True, True)
    params = (rife.load_params(rife.bundled_checkpoint())
              if args.motion_mode == "learned" else None)
    assert pipeline.unported_settings(cfg, args.precision, params) == []
    frames = [torch.from_numpy(f.view(np.int32).reshape(64, 64))
              for f in SyntheticSource(64, 64, n_frames=2)]
    outs = pipeline.make_interp_step(cfg, wire="i32", device="cpu",
                                     model_params=params)(*frames)
    assert len(outs) == 2
    for o in outs:
        assert o.dtype == torch.int32 and tuple(o.shape) == (64, 64)


def test_unported_config_raises_in_builders():
    cfg = EngineConfig(input_width=64, input_height=64, output_width=128,
                       output_height=128, temporal_mv=True)
    with pytest.raises(NotImplementedError, match="--temporal-mv"):
        pipeline.make_interp_step(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="--temporal-mv"):
        StreamingEngine(cfg, device="cpu")
    ok = EngineConfig(input_width=64, input_height=64, output_width=128,
                      output_height=128)
    with pytest.raises(NotImplementedError, match="y4m"):
        pipeline.make_scale_step(ok, sink_wire="y4m420", device="cpu")


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
