"""The readers of the program's per-frame spans on hand-made traces:
``ingest_ms.live``, ``ring_wait_ms.live``, ``handover_wait_ms.live``,
``motion_enqueue_ms`` and ``head_enqueue_ms`` pair the k-th span of each
name as input frame k, stop at the shorter list, give None without their
span, and with ``enqueue_ms`` and ``readback_ms.live`` tile each frame's
time in the program."""

import pytest

from fgbench import trace
from fgbench.spec import reader

US = 1e-6
NEW = ("ingest_ms.live", "ring_wait_ms.live", "handover_wait_ms.live",
       "motion_enqueue_ms", "head_enqueue_ms")


def X(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def read(name, t):
    return reader("metrics", name)(t)


# three frames a 33 ms period apart, each: ingest (us), the ring's wait,
# the step (with its motion stage from frame 1 on), the hand-over's wait,
# the readback
FRAMES = [
    # ingest start, ingest, ring wait, step, hand-over wait, readback
    (0, 2000, 64000, 3000, 30000, 10000),
    (33000, 2200, 63800, 3600, 29400, 10400),
    (66000, 1800, 64200, 3300, 29700, 9600),
]


def frame_events(frames=FRAMES, motion=True, head=False):
    ev = [X("fgbench.window", 0, 200000)]
    for k, (t0, ing, ring, step, hand, rb) in enumerate(frames):
        s = t0 + ing + ring
        r = s + step + hand
        ev += [X("tpufg.ingest", t0, ing), X("tpufg.step", s, step),
               X("tpufg.readback", r, rb)]
        if k and motion:
            ev.append(X("tpufg.step.motion", s + 100, step // 2))
        if k and head:
            ev.append(X("tpufg.step.head", s + 100, step // 3))
    return ev


def canned(ev):
    t = trace.parse(ev)
    t.frames_in = len(FRAMES)
    return t


def mean(xs):
    return sum(xs) / len(xs)


def test_each_reader_gives_the_mean_a_frame():
    # listed out of order: the readers sort each name by start
    t = canned(list(reversed(frame_events(head=True))))
    ms = 1e-3
    assert read("ingest_ms.live", t) == pytest.approx(
        mean([f[1] for f in FRAMES]) * ms)
    assert read("ring_wait_ms.live", t) == pytest.approx(
        mean([f[2] for f in FRAMES]) * ms)
    assert read("handover_wait_ms.live", t) == pytest.approx(
        mean([f[4] for f in FRAMES]) * ms)
    # frame 0 is scaled alone: the stages belong to frames 1 and 2
    assert read("motion_enqueue_ms", t) == pytest.approx(
        mean([f[3] // 2 for f in FRAMES[1:]]) * ms)
    assert read("head_enqueue_ms", t) == pytest.approx(
        mean([f[3] // 3 for f in FRAMES[1:]]) * ms)


@pytest.mark.parametrize("missing,silent", [
    # without ingest spans no readback is known to be one frame's
    ("tpufg.ingest", {"ingest_ms.live", "ring_wait_ms.live",
                      "handover_wait_ms.live"}),
    ("tpufg.step", {"ring_wait_ms.live", "handover_wait_ms.live"}),
    ("tpufg.readback", {"handover_wait_ms.live"}),
    ("tpufg.step.motion", {"motion_enqueue_ms"}),
    ("tpufg.step.head", {"head_enqueue_ms"}),
])
def test_a_missing_span_gives_nothing(missing, silent):
    t = canned([e for e in frame_events(head=True)
                if e["name"] != missing])
    for name in NEW:
        assert (read(name, t) is None) == (name in silent), name


def test_a_trace_of_the_parent_gives_nothing():
    """A program without these spans (only ``tpufg.step`` and
    ``tpufg.readback``, the first readback an empty flush) leaves every new
    metric out, and raises nothing."""
    t = canned([e for e in frame_events()
                if e["name"] in ("fgbench.window", "tpufg.step",
                                 "tpufg.readback")])
    assert [read(name, t) for name in NEW] == [None] * len(NEW)


def test_pairing_stops_at_the_shorter_list():
    # a fourth frame ingested (the ring's look-ahead) but never stepped
    ev = frame_events() + [X("tpufg.ingest", 99000, 5000)]
    # the last readback lost
    last_rb = max((e for e in ev if e["name"] == "tpufg.readback"),
                  key=lambda e: e["ts"])
    ev.remove(last_rb)
    t = canned(ev)
    ms = 1e-3
    assert read("ring_wait_ms.live", t) == pytest.approx(
        mean([f[2] for f in FRAMES]) * ms)
    assert read("handover_wait_ms.live", t) == pytest.approx(
        mean([f[4] for f in FRAMES[:2]]) * ms)
    assert read("ingest_ms.live", t) == pytest.approx(
        mean([f[1] for f in FRAMES] + [5000]) * ms)


def test_the_five_pieces_tile_each_frames_residence():
    t = canned(frame_events())
    pieces = sum(read(name, t) for name in (
        "ingest_ms.live", "ring_wait_ms.live", "enqueue_ms",
        "handover_wait_ms.live", "readback_ms.live"))
    ingest = sorted(t.spans["tpufg.ingest"])
    readback = sorted(t.spans["tpufg.readback"])
    residence = mean([r + d - i for (i, _), (r, d) in zip(ingest, readback)])
    assert pieces == pytest.approx(residence * 1e3)
    assert pieces == pytest.approx(mean([sum(f[1:]) for f in FRAMES]) * US
                                   * 1e3)
