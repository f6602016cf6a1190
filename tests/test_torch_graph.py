"""tpufg_torch.engine.graph (CPU): the stateless fast step replayed from one
captured call, and the engine's choice of it.

A CUDA graph runs on a card only; here ``GraphedStep`` is driven through
its seam, the graph backend.  ``FakeGraphs``'s capture records the
function and makes its outputs once; its replay runs the function again on
the static inputs and writes the results into those outputs, as a replay
writes into the captured step's buffers.  Checked: one capture, then only
replays; the static inputs refreshed from every call's prev and curr (the
engine's first pair too, whose prev went through the scale-only step);
the outputs equal the eager step's; an eager step and no capture inside
``plain_versions()`` and under ``debug_checks``; a shape change refused;
the engine graphs only a stateless fast step and hands a device sink
clones; ``StreamStats`` counts captures and replays, and the closing log
line prints them; the kernel wrappers' launch counts count what ran (the
warm-up and each replay, not the capture).  Config 4's step at 64 x 64 (identity size, where curr's
output is the static curr buffer itself) and 64 -> 128.  Tolerance: exact
(bytes, counts)."""

import numpy as np
import pytest
import torch

from tests.test_torch_ring import ReadySource, one_torch_thread
from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.graph import GraphedStep
from tpufg_torch.engine.pipeline import make_interp_step, make_scale_step
from tpufg_torch.engine.runner import StreamingEngine
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.kernels import convert, lanczos
from tpufg_torch.kernels.common import counted_wrappers, plain_versions
from tpufg_torch.models import rife
from tpufg_torch.utils.tracing import debug_checks

CPU = torch.device("cpu")
SIZES = {"identity": dict(input_width=64, input_height=64, output_width=64,
                          output_height=64),
         "2x": dict(input_width=64, input_height=64, output_width=128,
                    output_height=128)}


class FakeGraphs:
    """A graph backend on the CPU: ``capture`` runs ``fn`` once for its
    outputs; the replay it returns runs ``fn`` again and copies the
    results into them.  Counts each call."""

    def __init__(self):
        self.warms = self.captures = self.replays = 0

    def warm(self, fn, device):
        self.warms += 1
        fn()

    def capture(self, fn, device):
        self.captures += 1
        outs = fn()

        def replay():
            self.replays += 1
            for out, new in zip(outs, fn()):
                out.copy_(new)

        return replay, outs


def _wires(n, h=64, w=64):
    return [torch.from_numpy(f.view(np.int32).reshape(h, w))
            for f in SyntheticSource(w, h, n_frames=n)]


def _bytes(outs):
    return [o.numpy().tobytes() for o in outs]


def _step(size="identity", **opts):
    return make_interp_step(EngineConfig(**SIZES[size], **opts), wire="i32",
                            device=CPU)


def test_one_capture_then_only_replays():
    fake = FakeGraphs()
    graphed = GraphedStep(_step(), fake)
    wires = _wires(6)
    with one_torch_thread():
        for prev, curr in zip(wires, wires[1:]):
            graphed(prev, curr)
    assert (fake.warms, fake.captures, fake.replays) == (1, 1, 5)
    assert (graphed.captures, graphed.replays) == (1, 5)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("opts", [{}, {"motion_mode": "none"},
                                  {"fps_multiplier": 3}],
                         ids=["pyramid", "none", "x3"])
def test_outputs_equal_the_eager_steps(size, opts):
    """Every pair's outputs, read as they are returned, equal the eager
    step's; the static inputs hold the call's prev and curr; the outputs
    are the same static tensors every call."""
    step = _step(size, **opts)
    graphed = GraphedStep(step, FakeGraphs())
    wires = _wires(5)
    first = None
    with one_torch_thread():
        for prev, curr in zip(wires, wires[1:]):
            got = graphed(prev, curr)
            assert _bytes(got) == _bytes(step(prev, curr))
            assert all(torch.equal(buf, x)
                       for buf, x in zip(graphed._inputs, (prev, curr)))
            first = first or got
            assert all(a is b for a, b in zip(got, first))
    assert len(first) == max(2, opts.get("fps_multiplier", 2))


@pytest.mark.parametrize("scope", [plain_versions,
                                   lambda: debug_checks(True)],
                         ids=["plain_versions", "debug_checks"])
def test_eager_inside_plain_versions_and_debug_checks(scope):
    step = _step()
    fake = FakeGraphs()
    graphed = GraphedStep(step, fake)
    wires = _wires(3)
    with one_torch_thread():
        with scope():
            got = [_bytes(graphed(p, c)) for p, c in zip(wires, wires[1:])]
        assert (fake.warms, fake.captures, fake.replays) == (0, 0, 0)
        assert (graphed.captures, graphed.replays) == (0, 0)
        assert got == [_bytes(step(p, c)) for p, c in zip(wires, wires[1:])]
        # outside the scope the next call captures
        graphed(*wires[:2])
    assert (graphed.captures, graphed.replays) == (1, 1)


class QuietReplays(FakeGraphs):
    """FakeGraphs whose replay, like a CUDA graph's, calls no kernel
    wrapper: the launch counts its re-run adds are taken back."""

    def capture(self, fn, device):
        replay, outs = super().capture(fn, device)

        def quiet():
            counts = {f: f.launches for f in counted_wrappers()}
            replay()
            for f, n in counts.items():
                f.launches = n

        return quiet, outs


def test_launch_counts_count_what_ran(monkeypatch):
    """A step that makes one launch a call (counted as a wrapper counts it
    on a card): 2 after the first call (its warm-up and its replay; the
    capture runs nothing), one more a replay, one an eager call."""
    fn = convert.frames_to_planar
    monkeypatch.setattr(fn, "launches", 0)

    def step(prev, curr):
        fn.launches += 1
        return (prev + curr,)

    graphed = GraphedStep(step, QuietReplays())
    wires = _wires(5)
    counts = []
    for prev, curr in zip(wires, wires[1:]):
        graphed(prev, curr)
        counts.append(fn.launches)
    with plain_versions():
        graphed(*wires[:2])
    assert counts + [fn.launches] == [2, 3, 4, 5, 6]
    assert graphed._launched == ((fn, 1),)
    found = counted_wrappers()
    assert found.count(fn) == found.count(lanczos.lanczos_scale_packed) == 1


@pytest.mark.parametrize("other", ["shape", "dtype"])
def test_a_call_unlike_the_captured_one_raises(other):
    graphed = GraphedStep(_step(), FakeGraphs())
    wires = _wires(2)
    with one_torch_thread():
        graphed(*wires)
        prev, curr = wires
        if other == "shape":
            prev, curr = prev[:32], curr[:32]
        else:
            prev, curr = prev.view(torch.float32), curr.view(torch.float32)
        with pytest.raises(ValueError, match="captured for"):
            graphed(prev, curr)
    assert graphed.captures == 1


@pytest.fixture(scope="module")
def head():
    return rife.load_params(rife.bundled_checkpoint())


@pytest.mark.parametrize("opts,precision,graphed", [
    ({}, "fast", True),
    ({"motion_mode": "exhaustive"}, "fast", True),
    ({"motion_mode": "none"}, "fast", True),
    ({"scene_cut_threshold": 0.1}, "fast", True),
    ({"fps_multiplier": 4}, "fast", True),
    ({"temporal_mv": True}, "fast", False),
    ({"motion_mode": "learned"}, "fast", False),
    ({}, "exact", False),
    ({"enable_interpolation": False}, "fast", False),
], ids=["pyramid", "exhaustive", "none", "scene-cut", "x4", "temporal",
        "learned", "exact", "scale-only"])
def test_the_engine_graphs_only_a_stateless_fast_step(head, opts, precision,
                                                     graphed):
    cfg = EngineConfig(**SIZES["identity"], **opts)
    params = head if opts.get("motion_mode") == "learned" else None
    engine = StreamingEngine(cfg, precision, device=CPU, model_params=params)
    engine._build_steps("rgba", False)
    assert engine._graph is None   # a CPU engine's steps run eagerly
    engine._graphs = FakeGraphs()
    engine._built = None
    engine._build_steps("rgba", False)
    assert isinstance(engine._graph, GraphedStep) is graphed
    if graphed:
        assert engine._step2 is engine._graph


class Keeping(FrameSink):
    """Keeps every output as it is handed over, beside a copy of it."""

    def __init__(self, needs_host):
        self.needs_host = needs_host
        self.kept, self.copies = [], []

    def write(self, frame):
        self.kept.append(frame)
        self.copies.append(np.array(frame).tobytes())


def _engine(size, fake=None, **opts):
    engine = StreamingEngine(EngineConfig(**SIZES[size], **opts), device=CPU)
    if fake is not None:
        engine._graphs = fake
    return engine


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("needs_host", [True, False], ids=["host", "device"])
def test_the_engine_hands_over_what_the_eager_engine_does(size, needs_host):
    """The graphed engine's outputs, read at the end of the run, equal the
    bytes each had when it was handed over and the eager engine's (the
    first pair's prev also went through the scale-only step); a device
    sink's tensors are its own, not the graph's."""
    frames = list(SyntheticSource(64, 64, n_frames=6))
    runs = {}
    with one_torch_thread():
        for name, fake in (("eager", None), ("graphed", FakeGraphs())):
            engine = _engine(size, fake)
            sink = Keeping(needs_host)
            stats = engine.run(ReadySource(frames), sink, paced=False)
            runs[name] = (engine, sink, stats)
    engine, sink, stats = runs["graphed"]
    assert (stats.graph_captures, stats.graph_replays) == (1, 5)
    assert len(sink.kept) == stats.frames_out == 11
    eager = runs["eager"][1].copies
    assert [np.array(f).tobytes() for f in sink.kept] == sink.copies == eager
    if not needs_host:
        static = {o.data_ptr() for o in engine._graph._outs}
        static |= {b.data_ptr() for b in engine._graph._inputs}
        assert all(isinstance(f, torch.Tensor) for f in sink.kept)
        assert not static & {f.data_ptr() for f in sink.kept}


def test_stats_count_captures_and_replays_per_run(capsys):
    engine = _engine("identity", FakeGraphs())
    with one_torch_thread():
        first = engine.run(ReadySource(list(SyntheticSource(
            64, 64, n_frames=5))), Keeping(True), paced=False)
        second = engine.run(ReadySource(list(SyntheticSource(
            64, 64, n_frames=4))), Keeping(True), paced=False)
    assert (first.graph_captures, first.graph_replays) == (1, 4)
    assert (second.graph_captures, second.graph_replays) == (0, 3)
    log = capsys.readouterr().out
    assert "graph_captures 1, graph_replays 4" in log
    assert "graph_captures 0, graph_replays 3" in log


def test_a_temporal_engine_replays_nothing():
    engine = _engine("identity", FakeGraphs(), temporal_mv=True)
    with one_torch_thread():
        stats = engine.run(ReadySource(list(SyntheticSource(
            64, 64, n_frames=3))), Keeping(True), paced=False)
    assert stats.frames_out == 5
    assert (stats.graph_captures, stats.graph_replays) == (0, 0)


def test_the_scale_step_is_not_graphed():
    """Frame 0's scale-only step stays the plain step function."""
    engine = _engine("2x", FakeGraphs())
    engine._build_steps("rgba", False)
    wire = _wires(1)[0]
    assert not isinstance(engine._step1, GraphedStep)
    want = make_scale_step(EngineConfig(**SIZES["2x"]), wire="i32",
                           device=CPU)(wire)
    assert engine._step1(wire).numpy().tobytes() == want.numpy().tobytes()
