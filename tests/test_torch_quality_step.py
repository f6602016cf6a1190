"""Config 4q, tpufg's quality preset (``tools/bench_matrix.py``'s row 4q:
the per-pixel warp, sub-pel refine, MV bias 0.1, median filter, MC fallback
and occlusion blend), through the port's entry points against tpufg's
(CPU), and ``--quality on|auto`` through the command line on a CPU step.

Tolerances: the MV field within 1e-3 px (the sub-pel refine's, see
tests/test_torch_quality.py), the in-between frame within 2^-7 of tpufg's
(the per-pixel warp's bf16 seam through the blend options' slopes), the
step's bytes within 1 code on all but 1e-3 of them (measured: 3.6e-4 at
128 x 256 -> 256 x 512).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.config import EngineConfig as JConfig
from tpufg.engine import pipeline as jpipe
from tpufg.io.sources import SyntheticSource
from tpufg_torch import cli
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine import pipeline
from tpufg_torch.engine.runner import measure_step_rate
from tpufg_torch.kernels.convert import frames_to_planar

# tools/bench_matrix.py's row 4q, without the sizes
Q = dict(dtype="bf16", motion_mode="pyramid", mv_grid=1, subpel=True,
         mv_bias=0.1, mv_filter=True, mc_fallback=True, occlusion_blend=True)


def _wire(h, w, n=3, velocity=(3.0, 1.0)):
    return [f.view(np.int32).reshape(h, w)
            for f in SyntheticSource(w, h, n_frames=n, velocity=velocity)]


def test_4q_settings_are_ported():
    cfg = EngineConfig(input_width=256, input_height=128, output_width=512,
                       output_height=256, **Q)
    assert pipeline.unported_settings(cfg) == []
    assert "--quality" not in cli._unported_flags(
        cli.build_parser().parse_args(["synthetic:64x64", "--quality"]))


@pytest.mark.parametrize("opts", [
    Q, dict(Q, mv_grid=8), dict(motion_mode="pyramid", dtype="bf16",
                                occlusion_blend=True)],
    ids=["4q", "4q-mv-grid-8", "occlusion-at-16"])
def test_interp_planar_matches_tpufg(opts):
    """The interpolation core on a (3, 1) px/frame pan: the MV field after
    the refine and the filter, and the in-between frame."""
    h, w = 64, 128
    wire = _wire(h, w, n=2)
    kw = dict(mode="pyramid", factors=[0.5], block_size=8, search_radius=16,
              **{k: v for k, v in opts.items()
                 if k not in ("dtype", "motion_mode")})
    jp, jc = (jpipe.frames_to_planar(jnp.asarray(x), jnp.float32)
              for x in wire)
    (ref,), ref_mv = jpipe.interp_planar(jp, jc, dt=jnp.bfloat16,
                                         return_mv=True, **kw)
    (got,), mv = pipeline.interp_planar(
        *(frames_to_planar(torch.from_numpy(x)) for x in wire),
        dt=torch.bfloat16, return_mv=True, **kw)
    assert np.abs(mv.numpy() - np.asarray(ref_mv)).max() <= 1e-3
    assert got.shape == ref.shape == (4, h, w)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 2.0 ** -7


def test_4q_step_matches_tpufg():
    """The fps-doubling step at 2x upscale on the i32 wire, two pairs."""
    (h, w), (oh, ow) = (128, 256), (256, 512)
    frames = _wire(h, w)
    sizes = dict(input_width=w, input_height=h, output_width=ow,
                 output_height=oh)
    jstep = jpipe.make_interp_step(JConfig(**sizes, **Q), wire="i32")
    step = pipeline.make_interp_step(EngineConfig(**sizes, **Q), wire="i32",
                                     device="cpu")
    for i in range(2):
        refs = jstep(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1]))
        outs = step(torch.from_numpy(frames[i]),
                    torch.from_numpy(frames[i + 1]))
        assert len(outs) == len(refs) == 2
        for o, r in zip(outs, refs):
            a = o.numpy().view(np.uint8).astype(np.int16)
            b = np.asarray(r).view(np.uint8).astype(np.int16)
            assert a.shape == b.shape == (oh, ow * 4)
            d = np.abs(a - b)
            assert d.max() <= 1
            assert (d > 0).mean() <= 1e-3


def _cli_on_cpu(monkeypatch, argv):
    """Run the command line with the CPU as its device; return (exit code,
    stats, the config the stream ran with)."""
    seen = {}
    run_stream = cli.run_stream

    def spy(cfg, *args, **kwargs):
        seen["cfg"] = cfg
        return run_stream(cfg, *args, **kwargs)

    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "cpu")
    monkeypatch.setattr(cli, "run_stream", spy)
    rc, stats = cli.run(["synthetic:64x64", "--frames", "3", "--no-pacing",
                         *argv])
    return rc, stats, seen.get("cfg")


def test_cli_quality_on(monkeypatch):
    rc, stats, cfg = _cli_on_cpu(monkeypatch, ["--quality", "on",
                                               "--occlusion-blend"])
    assert rc == 0 and stats.frames_out == 5
    assert (cfg.mv_grid, cfg.subpel, cfg.mv_bias, cfg.mv_filter,
            cfg.mc_fallback, cfg.occlusion_blend) == (1, True, 0.1, True,
                                                      True, True)
    # explicit flags beat the preset
    rc, _, cfg = _cli_on_cpu(monkeypatch, ["--quality", "--mv-grid", "8",
                                           "--mv-bias", "0.2"])
    assert rc == 0 and (cfg.mv_grid, cfg.mv_bias, cfg.subpel) == (8, 0.2,
                                                                  True)


@pytest.mark.parametrize("rate", [None, 1e9, 0.0],
                         ids=["measured", "fast", "too-slow"])
def test_cli_quality_auto(monkeypatch, capsys, rate):
    """``auto`` measures the preset's step rate (the real measurement on
    the CPU, or a stated rate) and keeps the preset exactly when it
    sustains 1.5x the target input rate (1.5 pairs/s at --target-fps 1)."""
    seen = []
    measure = cli.measure_step_rate

    def rate_of(cfg, device=None):
        seen.append(measure(cfg, device=device) if rate is None else rate)
        return seen[-1]

    monkeypatch.setattr(cli, "measure_step_rate", rate_of)
    rc, stats, cfg = _cli_on_cpu(monkeypatch, ["--quality", "auto",
                                               "--target-fps", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and stats.frames_out == 5 and len(seen) == 1
    kept = seen[0] >= 1.5
    assert (cfg.mv_grid == 1) == kept
    assert ("quality preset on" if kept
            else "keeping the latency defaults") in out


def test_measure_step_rate_on_cpu():
    cfg = EngineConfig(input_width=64, input_height=64, output_width=64,
                       output_height=64, **Q)
    assert measure_step_rate(cfg, n=2, device="cpu") > 0.0
