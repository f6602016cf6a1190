"""tpufg_torch.utils.tracing (CPU): the profiler session, the reader of
the spans' device durations (``module_durations_ms``, on hand-made traces
as tests/test_tracing.py reads tpufg's), the engine's spans (one of
``tpufg.ingest``, ``tpufg.step`` and ``tpufg.readback`` a frame, in order,
the step's stages nested in its step, RIFE's IFNet's three among them;
against a live source each readback
before the next frame's ingest, and the engine's waits for the source,
``tpufg.ring.arrival_wait``), ``annotate``'s no-op when no
profiler is on, the latency recorder, the NaN guard of ``--debug-checks``
and the two flags through the command line.  Tolerance: exact (counts,
names, durations of hand-made events, output bytes)."""

import glob
import gzip
import json
import time

import numpy as np
import pytest
import torch

from tests.test_torch_ring import LiveSource, one_torch_thread
from tpufg_torch import cli
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.runner import StreamingEngine, run_stream
from tpufg_torch.io.sinks import FrameSink, NullSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.models import rife
from tpufg_torch.utils import tracing
from tpufg_torch.utils.tracing import (annotate, debug_checks,
                                       module_durations_ms, nan_guard_active,
                                       trace_session)

STAGES = ("tpufg.step.unpack", "tpufg.step.motion", "tpufg.step.warp",
          "tpufg.step.scale")
# config 4 at 64 x 64: 2x Lanczos up, the pyramid, fps doubled
C4_SMALL = dict(input_width=64, input_height=64, output_width=128,
                output_height=128)


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


class _ListSink(FrameSink):
    """Keeps a copy of every output (the engine reads each back)."""

    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))


def _spans(trace_dir) -> dict:
    """The host spans of the trace under ``trace_dir``: name -> sorted
    (start, end) in us."""
    out: dict = {}
    for e in _read(trace_dir):
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    return {n: sorted(v) for n, v in out.items()}


def _traced_run(trace_dir, cfg, n, model_params=None):
    sink = _ListSink()
    with trace_session(str(trace_dir)):
        stats = run_stream(cfg, SyntheticSource(cfg.input_width,
                                                cfg.input_height,
                                                n_frames=n),
                           sink, paced=False, device="cpu",
                           model_params=model_params)
    assert stats.frames_in == n
    return _spans(str(trace_dir)), sink


def test_engine_spans_every_stage_of_every_frame(tmp_path):
    n = 5
    spans, _ = _traced_run(tmp_path, EngineConfig(**C4_SMALL), n)
    for name in ("tpufg.ingest", "tpufg.step", "tpufg.readback"):
        assert len(spans[name]) == n, name
    steps = spans["tpufg.step"]
    for name in STAGES:
        # frame 0 is scaled alone: the stages run from frame 1 on
        assert len(spans[name]) == n - 1, name
        for lo, hi in spans[name]:
            assert any(s <= lo and hi <= e for s, e in steps[1:]), name
    assert "tpufg.step.head" not in spans


def test_engine_spans_follow_each_frame_in_order(tmp_path):
    """Frame k's ingest ends before its step starts, and its step ends
    before its readback starts: the k-th span of each name is frame k's."""
    spans, _ = _traced_run(tmp_path, EngineConfig(**C4_SMALL), 5)
    for ingest, step, readback in zip(spans["tpufg.ingest"],
                                      spans["tpufg.step"],
                                      spans["tpufg.readback"]):
        assert ingest[1] <= step[0] and step[1] <= readback[0]
    # the stages of one step run in order
    for k in range(4):
        ends = [spans[name][k] for name in STAGES]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_live_source_spans_each_frame_before_the_next_arrives(tmp_path):
    """Against a live source (a frame every 200 ms; a step takes a few ms
    here) frame k's outputs are handed over before frame k + 1 is taken
    in, on the same spans, and the engine's waits for a frame are
    spanned."""
    n = 4
    cfg = EngineConfig(input_width=64, input_height=64, output_width=64,
                       output_height=64)
    frames = list(SyntheticSource(64, 64, n_frames=n))
    engine = StreamingEngine(cfg, device="cpu")
    with one_torch_thread():
        engine.run(frames, _ListSink(), paced=False)   # warms the steps up
        with trace_session(str(tmp_path)):
            stats = engine.run(LiveSource(frames, 0.2), _ListSink(),
                               paced=False)
    assert stats.frames_in == n
    spans = _spans(str(tmp_path))
    for name in ("tpufg.ingest", "tpufg.step", "tpufg.readback"):
        assert len(spans[name]) == n, name
    ingest, step, readback = (spans[name] for name in (
        "tpufg.ingest", "tpufg.step", "tpufg.readback"))
    for k in range(n):
        assert ingest[k][1] <= step[k][0] and step[k][1] <= readback[k][0]
    for k in range(n - 1):
        # the hand-over no longer waits for the next frame
        assert readback[k][0] < ingest[k + 1][1], k
    assert len(spans["tpufg.ring.arrival_wait"]) >= n


def test_learned_step_spans_its_head(tmp_path):
    cfg = EngineConfig(input_width=64, input_height=48, output_width=64,
                       output_height=48, motion_mode="learned")
    params = rife.load_params(rife.bundled_checkpoint())
    spans, _ = _traced_run(tmp_path, cfg, 3, model_params=params)
    for name in ("tpufg.step.unpack", "tpufg.step.head", "tpufg.step.warp",
                 "tpufg.step.scale"):
        assert len(spans[name]) == 2, name
    assert "tpufg.step.motion" not in spans
    steps = spans["tpufg.step"]
    for lo, hi in spans["tpufg.step.head"]:
        assert any(s <= lo and hi <= e for s, e in steps), "head"


def _ifnet():
    return rife.load_params(rife.bundled_checkpoint().replace(
        "head64_v4.npz", "rife_ifnet_seed.json"))


def test_ifnet_step_spans_its_stages(tmp_path):
    """RIFE's IFNet: each pair opens ``tpufg.step.ifnet`` and
    ``tpufg.step.refine`` once and the new frame's ``tpufg.step.context``
    once, in that order inside its step; no head, motion or warp stage (no
    scene cut asked for)."""
    cfg = EngineConfig(input_width=64, input_height=64, output_width=64,
                       output_height=64, motion_mode="learned",
                       learned_scale=0.5)
    n = 4
    spans, sink = _traced_run(tmp_path, cfg, n, model_params=_ifnet())
    assert len(sink.frames) == 2 * n - 1
    stages = ("tpufg.step.ifnet", "tpufg.step.context", "tpufg.step.refine")
    for name in ("tpufg.step.unpack", "tpufg.step.scale") + stages:
        assert len(spans[name]) == n - 1, name
    for name in ("tpufg.step.head", "tpufg.step.motion", "tpufg.step.warp"):
        assert name not in spans
    for k, step in enumerate(spans["tpufg.step"][1:]):
        own = [spans[name][k] for name in stages]
        assert all(step[0] <= lo and hi <= step[1] for lo, hi in own)
        assert all(a[1] <= b[0] for a, b in zip(own, own[1:]))


def test_ifnet_step_opens_nothing_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    cfg = EngineConfig(input_width=64, input_height=64, output_width=64,
                       output_height=64, motion_mode="learned")
    stats = run_stream(cfg, SyntheticSource(64, 64, n_frames=3), NullSink(),
                       paced=False, device="cpu", model_params=_ifnet())
    assert stats.frames_in == 3


def test_annotate_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    first = annotate("tpufg.step")
    assert annotate("tpufg.ingest") is first
    with first, annotate("tpufg.readback"):
        pass
    # the engine's own spans go the same way
    stats = run_stream(EngineConfig(**C4_SMALL),
                       SyntheticSource(64, 64, n_frames=3), NullSink(),
                       paced=False, device="cpu")
    assert stats.frames_in == 3
    monkeypatch.undo()
    with trace_session(None):
        assert annotate("tpufg.step") is first
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert annotate("tpufg.step") is not tracing._NO_SPAN


def test_outputs_are_identical_with_and_without_a_trace(tmp_path):
    cfg = EngineConfig(**C4_SMALL)
    _, traced = _traced_run(tmp_path, cfg, 4)
    plain = _ListSink()
    run_stream(cfg, SyntheticSource(64, 64, n_frames=4), plain, paced=False,
               device="cpu")
    assert len(traced.frames) == len(plain.frames) == 7
    for a, b in zip(traced.frames, plain.frames):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("paced", [False, True], ids=["unpaced", "paced"])
def test_latency_is_each_frames_time_in_the_program(paced):
    """One sample an input frame, from its arrival at the ring to its last
    output handed over; none negative, none longer than the run."""
    cfg = EngineConfig(**C4_SMALL, target_fps=240)
    engine = StreamingEngine(cfg, device="cpu")
    n = 6
    t0 = time.perf_counter()
    stats = engine.run(SyntheticSource(64, 64, n_frames=n), _ListSink(),
                       paced=paced)
    wall = time.perf_counter() - t0
    assert stats.frames_in == n and stats.latency["n"] == n
    assert len(engine._lat) == n
    assert 0.0 <= engine._lat.percentile(0) <= engine._lat.percentile(100)
    assert engine._lat.percentile(100) <= wall
    # a second run records its own frames only
    engine.run(SyntheticSource(64, 64, n_frames=2), _ListSink(),
               paced=False)
    assert len(engine._lat) == 2


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
