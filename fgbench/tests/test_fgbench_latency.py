"""Latency accounting on a fake clock and a fake engine: frames are due on
the source's schedule, outputs map to the input frame they belong to,
and a stall counts against every later frame."""

import collections

import numpy as np
import pytest

from fgbench import check, load, readers
from fgbench.harness import Record


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


def fake_engine(source, sink, clock, work, k=2, depth=2):
    """The port's loop in miniature: a ring that reads ``depth`` frames
    ahead, a step of ``work(i)`` seconds, and frame i's outputs handed to
    the sink one frame late (k of them, frame 0 one)."""
    it = iter(source)
    ring = collections.deque()

    def fill():
        while len(ring) < depth:
            f = next(it, None)
            if f is None:
                return
            ring.append(f)

    fill()
    pending, i = [], 0
    while ring:
        f = ring.popleft()
        fill()
        clock.sleep(work(i))
        for o in pending:
            sink.write(o)
        pending = [f] * (1 if i == 0 else k)
        i += 1
    for o in pending:
        sink.write(o)


def run(n=120, fps=60.0, work=lambda i: 0.001, k=2):
    clock = Clock()
    bank = np.zeros((4, 2, 2, 4), np.uint8)
    src = load.BankSource(bank, fps=fps, count=n, clock=clock,
                          sleep=clock.sleep)
    sink = load.RecordingSink("rgba", k, clock=clock)
    fake_engine(src, sink, clock, work, k)
    return Record(t0=src.t0, seconds=n / fps, source=src, sink=sink,
                  setup_s=1.0)


def test_due_times_follow_the_schedule():
    r = run(n=10)
    assert r.source.offered == 10
    assert [r.source.due(i) - r.t0 for i in (0, 1, 9)] == pytest.approx(
        [0.0, 1 / 60, 9 / 60])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_outputs_map_to_their_input_frame(k):
    r = run(n=7, k=k)
    sink = r.sink
    assert len(sink.times) == 1 + 6 * k
    assert sink.delivered() == 7
    assert [sink.frame_of(j) for j in range(1 + 2 * k)] == (
        [0] + [1] * k + [2] * k)
    assert [sink.last_output(i) for i in range(3)] == [0, k, 2 * k]


def test_steady_latency_is_the_look_ahead_plus_the_late_hand_over():
    r = run()
    lat = readers.latencies_ms(r)
    assert len(lat) == 120
    # frame i enters the step once frame i + 2 is due, and its outputs
    # leave in the next iteration, once frame i + 3 is due: 3 periods
    # and a step of 1 ms
    steady = lat[1:-3]
    assert steady == pytest.approx(np.full(len(steady), 3000 / 60 + 1.0))
    assert readers.percentile_ms(r, 50) == pytest.approx(51.0)


def test_a_stall_counts_against_later_frames():
    base = readers.latencies_ms(run())
    r = run(work=lambda i: 0.2 if i == 30 else 0.001)
    lat = readers.latencies_ms(r)
    # the stall of frame 30's step delays frame 29's hand-over and every
    # frame queued behind it until the loop catches up
    assert lat[29] == pytest.approx(base[29] + 199.0)
    assert (lat[30:37] > base[30:37] + 50).all()
    assert (np.diff(lat[29:40]) < 0).all()    # caught up a step at a time
    assert lat[-10:] == pytest.approx(base[-10:])
    assert readers.percentile_ms(r, 99) > 150
    assert r.source.late_s > 0.1


def test_out_fps_counts_the_outputs_inside_the_window():
    clock = Clock()
    bank = np.zeros((4, 2, 2, 4), np.uint8)
    src = load.BankSource(bank, seconds=1.0, clock=clock, sleep=clock.sleep)
    sink = load.RecordingSink("y4m420", 2, clock=clock)
    fake_engine(src, sink, clock, lambda i: 0.01)
    r = Record(t0=src.t0, seconds=1.0, source=src, sink=sink, setup_s=1.0)
    from fgbench.spec import reader
    fps = reader("end_to_end", "out_fps")(r)
    # a step every 10 ms, each handing over the frame before: about 100
    # frames' outputs inside the second (two each, frame 0 one); the ring
    # has pulled two more when the source stops offering
    assert 101 <= src.offered <= 103
    assert 195 <= fps <= 199
    assert reader("end_to_end", "latency_p99_ms")(r) is None


@pytest.mark.parametrize("count", [None, 500])
def test_the_sample_is_seeded_bounded_and_keeps_frame_0(count):
    def kept(seed, n=500):
        sink = load.RecordingSink("y4m420", 2, check.Sample(seed, 12, count))
        for j in range(1 + 2 * (n - 1)):
            sink.write(np.full((2, 3), j % 251, np.uint8))
        return sink.kept

    a, b, c = kept(2 ** 31 + 5), kept(2 ** 31 + 5), kept(7)
    assert a.keys() == b.keys() and a.keys() != c.keys()
    assert 0 in a and len(a) == 13
    assert all(len(v) == (1 if i == 0 else 2) for i, v in a.items())
    # each kept output is the one written for its frame
    for i, outs in a.items():
        want = [0] if i == 0 else [(2 * i - 1) % 251, (2 * i) % 251]
        assert [int(o[0, 0]) for o in outs] == want
    # spread over the window, not its start
    assert max(a) > 250


def test_outputs_per_second_of_the_window():
    from fgbench.harness import per_second
    times = [100.0, 100.5, 100.99, 101.0, 102.7, 103.2, 99.9]
    assert per_second(times, 100.0, 3) == [3, 1, 1]
    assert per_second([], 100.0, 0.5) == [0]
