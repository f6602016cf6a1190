"""tpufg_torch.engine.runner (CPU): the hand-over of each frame's outputs.

Every frame's outputs reach the sink before the next frame is pulled from
the source: against a live source (``tests/test_torch_ring.LiveSource``)
before the next frame is due, and against a ready source too; the frames,
their bytes and their order are the same either way.  Config 4's step at
64 x 64 identity size (fps doubled), 3-5 ms a step on one CPU thread,
against a source period of 200 ms.  Tolerance: exact (bytes, counts, the
order of events)."""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_ring import LiveSource, ReadySource, one_torch_thread
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.runner import StreamingEngine
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.io.sources import SyntheticSource

N = 5
PERIOD = 0.2
CFG = dict(input_width=64, input_height=64, output_width=64,
           output_height=64)


class TimedSink(FrameSink):
    """Keeps a copy of every output and when it arrived."""

    def __init__(self):
        self.frames, self.times = [], []

    def write(self, frame):
        self.times.append(time.perf_counter())
        self.frames.append(np.array(frame))


def _frames(n=N):
    return list(SyntheticSource(64, 64, n_frames=n))


@pytest.fixture(scope="module")
def runs():
    """One engine; a ready run (which also warms the steps up), then a
    live one over the same frames."""
    engine = StreamingEngine(EngineConfig(**CFG), device="cpu")
    with one_torch_thread():
        ready_src, ready = ReadySource(_frames()), TimedSink()
        engine.run(ready_src, ready, paced=False)
        live_src, live = LiveSource(_frames(), PERIOD), TimedSink()
        live_stats = engine.run(live_src, live, paced=False)
    return live_src, live, live_stats, ready_src, ready


def test_each_frame_is_handed_over_before_the_next_is_due(runs):
    src, sink, stats, _, _ = runs
    assert stats.frames_in == N and stats.frames_out == 2 * N - 1
    for k in range(N - 1):
        # frame k's last output is the sink's output 2k (fps doubled)
        assert sink.times[2 * k] < src.due[k + 1], k


@pytest.mark.parametrize("side", ["live", "ready"])
def test_each_frame_is_handed_over_before_the_next_is_pulled(runs, side):
    live_src, live, _, ready_src, ready = runs
    src, sink = (live_src, live) if side == "live" else (ready_src, ready)
    for k in range(N - 1):
        assert sink.times[2 * k] < src.handed[k + 1], k


def test_live_outputs_equal_the_closed_loops(runs):
    _, live, _, _, ready = runs
    assert len(live.frames) == len(ready.frames) == 2 * N - 1
    for a, b in zip(live.frames, ready.frames):
        assert a.tobytes() == b.tobytes()


def test_the_source_is_read_on_the_engines_thread(runs):
    live_src, _, _, ready_src, _ = runs
    assert live_src.threads == ready_src.threads == {threading.get_ident()}


@pytest.mark.parametrize("max_frames", [0, 1, 3])
def test_max_frames_reads_the_source_no_further(max_frames):
    src = ReadySource(_frames())
    sink = TimedSink()
    stats = StreamingEngine(EngineConfig(**CFG), device="cpu").run(
        src, sink, max_frames=max_frames, paced=False)
    assert stats.frames_in == max_frames == len(src.handed)
    assert stats.frames_out == max(0, 2 * max_frames - 1)


def test_a_step_error_stops_the_reads(monkeypatch):
    engine = StreamingEngine(EngineConfig(**CFG), device="cpu")
    engine._build_steps("rgba", False)

    def broken(prev, curr):
        raise RuntimeError("step failed")

    engine._step2 = broken
    monkeypatch.setattr(engine, "_build_steps", lambda *a: None)
    src, sink = LiveSource(_frames(), 0.02), TimedSink()
    with pytest.raises(RuntimeError, match="step failed"):
        engine.run(src, sink, paced=False)
    # frame 0 was scaled and handed over; frame 1's step failed
    assert len(src.handed) == 2 and len(sink.frames) == 1
