"""tpufg_torch.utils.tracing (CPU): the profiler session, the reader of
the spans' device durations (``module_durations_ms``, on hand-made traces
as tests/test_tracing.py reads tpufg's), the engine's spans, the NaN guard
of ``--debug-checks`` and the two flags through the command line.
Tolerance: exact (counts, names, durations of hand-made events)."""

import glob
import gzip
import json

import numpy as np
import pytest
import torch

from tpufg_torch import cli
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.io.sinks import NullSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.utils.tracing import (annotate, debug_checks,
                                       module_durations_ms, nan_guard_active,
                                       trace_session)


def _write_trace(tmp_path, events):
    d = tmp_path / "nested"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _read(trace_dir):
    files = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def test_module_durations_reads_gpu_user_annotations(tmp_path):
    events = [
        # two steps on the device (duration in us)
        {"ph": "X", "cat": "gpu_user_annotation", "name": "tpufg.step",
         "ts": 100, "dur": 4480},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "tpufg.step",
         "ts": 5000, "dur": 4520},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "tpufg.readback",
         "ts": 9000, "dur": 100},
        # the host side of the same span is not a device duration
        {"ph": "X", "cat": "user_annotation", "name": "tpufg.step",
         "ts": 90, "dur": 9999},
    ]
    durs = module_durations_ms(_write_trace(tmp_path, events))
    assert durs == {"tpufg.step": [4.48, 4.52], "tpufg.readback": [0.1]}


def test_module_durations_falls_back_to_the_spans_kernels(tmp_path):
    """Without gpu_user_annotation events: first kernel start to last
    kernel end of the kernels the span's launches made."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "tpufg.step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 5, "args": {"correlation": 2}},
        # launched after the span: not the span's
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 150, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200, "dur": 300,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 600, "dur": 400,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 1100, "dur": 50,
         "args": {"correlation": 3}},
        # a span that launched nothing has no device duration
        {"ph": "X", "cat": "user_annotation", "name": "tpufg.readback",
         "ts": 120, "dur": 20},
    ]
    durs = module_durations_ms(_write_trace(tmp_path, events))
    assert durs == {"tpufg.step": [0.8]}


def test_module_durations_empty_without_trace(tmp_path):
    assert module_durations_ms(str(tmp_path)) == {}


def test_trace_session_writes_a_parseable_trace(tmp_path):
    with trace_session(str(tmp_path)):
        for _ in range(3):
            with annotate("tpufg.step"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    events = _read(str(tmp_path))
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("tpufg.step") == 3
    # a CPU-only trace records no device work
    assert module_durations_ms(str(tmp_path)) == {}


def test_trace_session_none_is_a_no_op(tmp_path):
    with trace_session(None):
        torch.ones(2) + 1
    with trace_session(""):
        torch.ones(2) + 1
    assert not list(tmp_path.iterdir())


def test_engine_spans_each_step_and_readback(tmp_path):
    cfg = EngineConfig(input_width=64, input_height=64, output_width=128,
                       output_height=128)
    with trace_session(str(tmp_path)):
        stats = run_stream(cfg, SyntheticSource(64, 64, n_frames=4),
                           NullSink(), paced=False, device="cpu")
    assert stats.frames_in == 4
    names = [e["name"] for e in _read(str(tmp_path))
             if e.get("cat") == "user_annotation"]
    assert names.count("tpufg.step") == 4
    assert names.count("tpufg.readback") == 4


def test_debug_checks_raise_at_the_first_nan():
    zero = torch.zeros(3)
    with debug_checks(True):
        assert nan_guard_active()      # the kernels' launches check too
        x = torch.ones(3) * 2          # finite: passes
        with pytest.raises(FloatingPointError, match="div"):
            zero / zero
        with pytest.raises(FloatingPointError):
            torch.log(-x)
    assert not nan_guard_active()


def test_debug_checks_pass_uninitialised_memory_views_and_integers():
    nan = torch.full((4,), float("nan"))
    with debug_checks(True):
        torch.empty(1 << 16)
        nan[1:3]                        # a view computes nothing
        torch.arange(5) // 2
        with pytest.raises(FloatingPointError):
            nan + 1


def test_debug_checks_are_inert_when_off():
    zero = torch.zeros(3)
    with debug_checks(False):
        assert not nan_guard_active()
        assert torch.isnan(zero / zero).all()


def _cli_on_cpu(monkeypatch, argv):
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "cpu")
    return cli.run(["synthetic:64x64", "--frames", "3", "--no-pacing",
                    *argv])


def test_cli_trace_writes_the_run(monkeypatch, tmp_path):
    rc, stats = _cli_on_cpu(monkeypatch, ["--trace", str(tmp_path / "t")])
    assert rc == 0 and stats.frames_out == 5
    names = [e["name"] for e in _read(str(tmp_path / "t"))
             if e.get("cat") == "user_annotation"]
    assert names.count("tpufg.step") == 3


@pytest.mark.parametrize("argv", [[], ["--precision", "exact",
                                       "--block-size", "4",
                                       "--search-radius", "2"]],
                         ids=["fast", "exact"])
def test_cli_debug_checks_pass_a_clean_run(monkeypatch, argv):
    rc, stats = _cli_on_cpu(monkeypatch, ["--debug-checks", *argv])
    assert rc == 0 and stats.frames_out == 5
    assert not nan_guard_active()
    assert np.isfinite(stats.fps)
