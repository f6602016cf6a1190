"""tpufg_torch.engine.runner (CPU): the hand-over of each frame's outputs.

Every frame's outputs reach the sink before the next frame is pulled from
the source: against a live source (``tests/test_torch_ring.LiveSource``)
before the next frame is due, and against a ready source too; the frames,
their bytes and their order are the same either way.  Config 4's step at
64 x 64 identity size (fps doubled), 3-5 ms a step on one CPU thread,
against a source period of 200 ms.

The readback into pinned host blocks (``HostReadback``) runs on a CUDA
device only; here it is driven through its seam, a host allocator: on the
CPU ``HostCache`` stands in for torch's caching host allocator, and takes
a block back as soon as nothing holds it or a view of it.  The bytes
handed over are the step's, on either route; a device sink gets tensors
and the engine's every-8th sync; arrays a sink keeps, whole or as views,
are never written again; the top-up follows a frame's last write; and the
counters count outputs and the blocks made.  Tolerance: exact (bytes,
counts, the order of events)."""

import collections
import threading
import time
import weakref

import numpy as np
import pytest

import torch

from tests.test_torch_ring import LiveSource, ReadySource, one_torch_thread
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine import runner
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


class HostCache:
    """torch's caching host allocator in small, on the CPU: ``empty``
    hands out a block of the shape from its free list, or makes one
    (``made`` counts them); a block goes back to the free list once
    nothing holds the tensor handed out for it, its numpy view, or any
    view of that.  Each call is logged into ``log``."""

    def __init__(self, log=None):
        self.free = collections.defaultdict(list)
        self.made = 0
        self.log = [] if log is None else log

    def empty(self, shape, dtype):
        self.log.append("empty")
        key = (tuple(shape), dtype)
        if self.free[key]:
            block = self.free[key].pop()
        else:
            block = torch.empty(shape, dtype=dtype).numpy()
            self.made += 1
        held = block.view()  # alive while the tensor's storage is
        weakref.finalize(held, self.free[key].append, block)
        return torch.from_numpy(held)

    def allocs(self):
        return self.made


class KeepingSink(FrameSink):
    """Keeps ``keep(j, frame)`` of output j where it is not None, beside a
    copy of its bytes taken at the write; drops every other output.
    Logs each write into ``log``."""

    def __init__(self, keep=lambda j, frame: None, needs_host=True,
                 log=None):
        self.keep, self.needs_host = keep, needs_host
        self.log = [] if log is None else log
        self.kept, self.types = [], []

    def write(self, frame):
        self.log.append("write")
        self.types.append(type(frame))
        held = self.keep(len(self.types) - 1, frame)
        if held is not None:
            self.kept.append((held, np.array(held)))


def _engine(host=None):
    engine = StreamingEngine(EngineConfig(**CFG), device="cpu")
    if host is not None:
        engine._host = host
    return engine


@pytest.mark.parametrize("route", ["cpu", "pinned"])
def test_the_bytes_handed_over_are_the_steps(route):
    """Every output as the step made it, in the step's order: on the CPU
    route as the step's own tensors, on the pinned route from a block."""
    frames = _frames(6)
    engine = _engine(HostCache() if route == "pinned" else None)
    sink = KeepingSink(keep=lambda j, frame: frame)
    with one_torch_thread():
        stats = engine.run(ReadySource(frames), sink, paced=False)
        wires = [torch.from_numpy(f.view(np.int32).reshape(64, 64))
                 for f in frames]
        want = [engine._step1(wires[0])]
        for prev, curr in zip(wires, wires[1:]):
            want += list(engine._step2(prev, curr))
    assert len(sink.kept) == len(want) == stats.frames_out == 11
    for (got, _), w in zip(sink.kept, want):
        assert got.dtype == np.uint8 and got.shape == (64, 64, 4)
        assert got.tobytes() == w.numpy().tobytes()
    pinned = 11 if route == "pinned" else 0
    assert stats.readback_pinned == pinned


@pytest.mark.parametrize("needs_host,paced,synced", [
    (False, False, [3, 11, 19]),
    (False, True, list(range(1, 21))),
    (True, False, []),
    (True, True, []),
])
def test_only_a_device_sink_is_synchronised(monkeypatch, needs_host, paced,
                                            synced):
    """A device sink (``needs_host`` false) takes the step's tensors, and
    the engine synchronises every 8th frame unpaced, every frame paced; a
    host sink's hand-over has waited on its copies already."""
    engine = _engine()
    sink = KeepingSink(needs_host=needs_host)
    seen = []
    # the input frames handed over when the engine synchronises
    monkeypatch.setattr(runner, "device_sync",
                        lambda x: seen.append((len(sink.types) + 1) // 2))
    with one_torch_thread():
        engine.run(ReadySource(_frames(20)), sink, paced=paced)
    kind = np.ndarray if needs_host else torch.Tensor
    assert len(sink.types) == 39
    assert all(issubclass(t, kind) for t in sink.types)
    assert seen == synced


VIEWS = {
    0: lambda frame: frame,                          # frame 0, whole
    5: lambda frame: np.asarray(frame),
    8: lambda frame: frame[20:40],                   # a slice of rows
    13: lambda frame: frame.view(np.int32)[:, 7],    # a re-view, a column
    21: lambda frame: frame.reshape(-1)[::3],
}


def test_kept_outputs_and_views_are_never_written_again():
    """A sink keeps some outputs, or only a view of one, and drops the
    rest; after many more frames, through blocks the cache hands out
    again, what it kept still holds the bytes it was handed."""
    cache = HostCache()
    sink = KeepingSink(keep=lambda j, frame: (VIEWS[j](frame) if j in VIEWS
                                              else None))
    with one_torch_thread():
        stats = _engine(cache).run(ReadySource(_frames(20)), sink,
                                   paced=False)
    assert stats.frames_out == 39 and len(sink.kept) == len(VIEWS)
    # the blocks went round: far fewer made than outputs handed over
    assert cache.made <= len(VIEWS) + 4
    for held, copy in sink.kept:
        assert np.array_equal(held, copy)
    # and the outputs differ, so a block written again would show
    assert len({copy.tobytes() for _, copy in sink.kept[:2]}) == 2


def test_the_top_up_follows_the_frames_last_write():
    """Per frame: its blocks, its writes, then the top-up's blocks (as
    many as a frame's outputs take, here 2), before the next frame's."""
    log = []
    sink = KeepingSink(log=log)
    with one_torch_thread():
        _engine(HostCache(log)).run(ReadySource(_frames(6)), sink,
                                    paced=False)
    frame = ["empty"] * 2 + ["write"] * 2 + ["empty"] * 2
    assert log == ["empty", "write", "empty", "empty"] + frame * 5


def test_the_counters_count_outputs_and_blocks_made():
    """A warm-up run, then a run whose sink keeps 1 frame in 10: every
    output is counted as read back pinned; no block is made inside a
    hand-over once warm, and the top-up makes one for each block kept."""
    cache = HostCache()
    engine = _engine(cache)
    keep = KeepingSink(keep=lambda j, frame: (
        frame if (j == 0 or (j - 1) // 2 % 10 == 9) else None))
    with one_torch_thread():
        warm = engine.run(ReadySource(_frames(4)), KeepingSink(),
                          paced=False)
        made = cache.made
        stats = engine.run(ReadySource(_frames(30)), keep, paced=False)
    assert warm.readback_pinned == 7
    assert warm.readback_host_allocs + warm.refill_host_allocs == made
    assert stats.readback_pinned == stats.frames_out == 59
    assert stats.readback_host_allocs == 0
    # frame 0's output, frames 10 and 20's two each
    assert len(keep.kept) == 5
    assert stats.refill_host_allocs == cache.made - made == 5
