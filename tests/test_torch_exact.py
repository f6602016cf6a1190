"""The port's exact precision path against tpufg's (CPU): the exact
interpolation step and the exact scale step against tpufg's jitted ones,
the engine and the command line with ``--precision exact``.

Same synthetic frames through both packages.  Tolerances:
- MV fields: bitwise (the port's exact MV against ``-oracle.motion_search``
  under ``jax.jit``);
- output bytes: bitwise at 2x and identity ratios; elsewhere within 1
  code, with at most 1% of the bytes differing (torch's CPU sine and
  XLA's differ in the last bit on some Lanczos taps at those ratios;
  measured here: 0 bytes at 30x48 -> 40x64 and 24x40 -> 36x60);
- run_stream: every frame bitwise (a 2x config).
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from tpufg.config import EngineConfig as JConfig
from tpufg.engine import pipeline as jpipe
from tpufg.engine.runner import run_stream as jrun_stream
from tpufg.ops import oracle as jo
from tpufg_torch import cli
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine import pipeline as tpipe
from tpufg_torch.engine.runner import StreamingEngine, run_stream
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.kernels.common import plain_versions
from tpufg_torch.ops import oracle as to

CPU = torch.device("cpu")

# (in hw, out hw, block, radius, fps multiplier, motion mode, bitwise)
CASES = [
    ((24, 40), (48, 80), 4, 2, 2, "pyramid", True),
    ((32, 48), (64, 96), 8, 4, 3, "exhaustive", True),
    ((24, 40), (24, 40), 4, 2, 2, "none", True),
    ((24, 40), (24, 40), 8, 4, 2, "pyramid", True),
    ((30, 48), (40, 64), 4, 2, 2, "pyramid", False),
    ((24, 40), (36, 60), 8, 4, 3, "none", False),
]


def _cfg(in_hw, out_hw, b=8, r=16, k=2, mode="pyramid", **kw):
    return EngineConfig(input_width=in_hw[1], input_height=in_hw[0],
                        output_width=out_hw[1], output_height=out_hw[0],
                        block_size=b, search_radius=r, fps_multiplier=k,
                        motion_mode=mode, **kw)


def _shared(cfg) -> dict:
    """The port's config as tpufg's takes it: its own field left out
    (``learned_scale``, RIFE's IFNet, which tpufg does not have)."""
    return {k: v for k, v in cfg.__dict__.items() if k != "learned_scale"}


def _key(cfg):
    return tuple(sorted(_shared(cfg).items()))


@functools.lru_cache(maxsize=None)
def _tpufg_step(key, exact_scale=False):
    """tpufg's jitted exact step for a config, compiled once per config."""
    cfg = JConfig(**dict(key))
    if exact_scale:
        return jpipe.make_exact_scale_step(cfg)
    return jpipe.make_interp_step(cfg, "exact")


def _frames(h, w, n=2):
    return list(SyntheticSource(w, h, n_frames=n))


def _assert_bytes(out, ref, bitwise):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    if bitwise:
        np.testing.assert_array_equal(out, ref)
        return
    d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.01


@pytest.mark.parametrize("in_hw,out_hw,b,r,k,mode,bitwise", CASES)
def test_exact_interp_step_matches_tpufg(in_hw, out_hw, b, r, k, mode,
                                         bitwise):
    cfg = _cfg(in_hw, out_hw, b, r, k, mode)
    fr = _frames(*in_hw)
    ref = _tpufg_step(_key(cfg))(*fr)
    out = tpipe.make_interp_step(cfg, "exact", device=CPU)(
        *map(torch.from_numpy, fr))
    assert len(out) == len(ref) == k
    for o, j in zip(out, ref):
        _assert_bytes(o.numpy(), j, bitwise)
    if mode != "none":
        p, c = (jo.dequantize_unorm8(f) for f in fr)
        jmv = -jax.jit(lambda x, y: jo.motion_search(x, y, b, r))(p, c)
        tmv = tpipe.exact_mv(*(to.dequantize_unorm8(torch.from_numpy(f))
                               for f in fr), b, r)
        np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
        assert np.abs(tmv.numpy()).max() > 0   # the pan moved something


@pytest.mark.parametrize("b,r", [(4, 2), (8, 4)])
def test_exact_mv_kernel_path_equals_oracle_on_cpu(b, r):
    """The step's search (the tiled search with the exact box, on planar
    copies; its plain version on the CPU) gives the oracle's MV field
    bitwise, as csrc/motion_tiled.cu does on the card."""
    p, c = (to.dequantize_unorm8(torch.from_numpy(f))
            for f in _frames(24, 40))
    np.testing.assert_array_equal(
        tpipe.exact_mv(p, c, b, r).numpy(),
        (-to.motion_search(p, c, b, r)).numpy())


@pytest.mark.parametrize("in_hw,out_hw,bitwise", [
    ((24, 40), (48, 80), True), ((48, 80), (48, 80), True),
    ((30, 48), (40, 64), False)])
def test_exact_scale_step_matches_tpufg(in_hw, out_hw, bitwise):
    cfg = _cfg(in_hw, out_hw)
    f = _frames(*in_hw, n=1)[0]
    ref = _tpufg_step(_key(cfg), exact_scale=True)(f)
    step = tpipe.make_exact_scale_step(cfg, device=CPU)
    for scope in (contextlib.nullcontext, plain_versions):
        with scope():
            out = step(torch.from_numpy(f))
        _assert_bytes(out.numpy(), ref, bitwise)


def test_exact_step_refuses_the_fast_wires():
    cfg = _cfg((24, 40), (48, 80))
    with pytest.raises(ValueError, match="uint8"):
        tpipe.make_interp_step(cfg, "exact", wire="i32", device=CPU)
    with pytest.raises(ValueError, match="y4m"):
        tpipe.make_interp_step(cfg, "exact", sink_wire="y4m420", device=CPU)
    with pytest.raises(ValueError, match="precision"):
        tpipe.make_interp_step(cfg, "fastest", device=CPU)
    # the engine reads RGBA back for the exact path, whatever the sink
    eng = StreamingEngine(cfg, precision="exact", device=CPU)

    class Y4m(FrameSink):
        wire_format = "y4m420"

    assert eng._sink_wire(Y4m()) == "rgba"
    assert StreamingEngine(cfg, device=CPU)._sink_wire(Y4m()) == "y4m420"


class _ListSink(FrameSink):
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))


@pytest.mark.parametrize("interp", [True, False])
def test_run_stream_exact_matches_tpufg(interp):
    cfg = _cfg((24, 40), (48, 80), 4, 2, enable_interpolation=interp,
               temporal_mv=True)
    ref, out = _ListSink(), _ListSink()
    jstats = jrun_stream(JConfig(**_shared(cfg)),
                         SyntheticSource(40, 24, n_frames=4), ref,
                         precision="exact", paced=False)
    stats = run_stream(cfg, SyntheticSource(40, 24, n_frames=4), out,
                       precision="exact", paced=False, device=CPU)
    assert stats.frames_in == jstats.frames_in == 4
    assert stats.frames_out == jstats.frames_out == len(out.frames) \
        == (7 if interp else 4)
    for o, r in zip(out.frames, ref.frames):
        np.testing.assert_array_equal(o, r)


def _cli_on_cpu(monkeypatch, argv):
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "cpu")
    return cli.run(["synthetic:40x24", "--output-width", "80",
                    "--output-height", "48", "--frames", "3",
                    "--no-pacing", "--block-size", "4", "--search-radius",
                    "2", "--precision", "exact", *argv])


@pytest.mark.parametrize("argv,frames_out", [([], 5), (["--no-interpolation"],
                                                      3),
                                             (["--fps-multiplier", "3"], 7)])
def test_cli_precision_exact_runs_on_a_cpu_step(monkeypatch, argv,
                                                frames_out):
    args = cli.build_parser().parse_args(["x", "--precision", "exact",
                                          *argv])
    assert tpipe.unported_settings(cli._config(args), args.precision) == []
    rc, stats = _cli_on_cpu(monkeypatch, argv)
    assert rc == 0 and stats.frames_in == 3
    assert stats.frames_out == frames_out
