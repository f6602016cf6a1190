"""tpufg_torch.engine.ring (CPU): the engine's frame ingest.

Each frame is pulled from the source only when the consumer asks for it
and is yielded before the next is pulled, from a live source (each frame
due a period after the last) and from a ready one alike; a source that
reuses one buffer yields the right bytes each time; a source's exception
is raised in the consumer after the frames before it; a consumer that
stops early leaves the source unread past its frames; and every pull runs
on the consumer's thread.  ``LiveSource`` is shared with the runner's and
the tracing tests.  Tolerance: exact (bytes, counts, the order of
events)."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from tpufg_torch.engine.ring import device_frames

CPU = torch.device("cpu")


def frames(n, h=4, w=4):
    """``n`` distinct uint8 [h, w, 4] frames: frame i holds the code i."""
    return [np.full((h, w, 4), i, dtype=np.uint8) for i in range(n)]


class LiveSource:
    """Hands ``frames`` over in real time: frame i at ``t0 + (i + 1) *
    period``, where ``t0`` is when the first is asked for.  Records when
    each frame was pulled (``handed``), when it was due (``due``) and the
    thread that pulled it (``threads``)."""

    const_alpha = None

    def __init__(self, frames, period):
        self.frames, self.period = list(frames), period
        self.due: list[float] = []
        self.handed: list[float] = []
        self.threads: set = set()

    def __iter__(self):
        t0 = time.perf_counter()
        for i, f in enumerate(self.frames):
            due = t0 + (i + 1) * self.period
            self.due.append(due)
            time.sleep(max(0.0, due - time.perf_counter()))
            self.handed.append(time.perf_counter())
            self.threads.add(threading.get_ident())
            yield f


class ReadySource(LiveSource):
    """Hands every frame over at once (a closed loop: a file, a pipe with
    a backlog)."""

    def __init__(self, frames):
        super().__init__(frames, 0.0)


@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU ops on one thread: on a loaded host, several threads
    of one op wait for each other, and a step of a few ms takes hundreds,
    longer than a live source's period."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def codes(t: torch.Tensor) -> set:
    return set(np.unique(t.numpy()).tolist())


@pytest.mark.parametrize("period", [0.0, 0.04])
def test_each_frame_is_yielded_before_the_next_is_pulled(period):
    src = LiveSource(frames(5), period)
    got = []
    for dev, arrival in device_frames(src, CPU):
        got.append((time.perf_counter(), arrival, codes(dev)))
        # the ring holds no frame ahead of the one it yields
        assert len(src.handed) == len(got)
    assert [c for _, _, c in got] == [{i} for i in range(5)]
    for k in range(4):
        assert got[k][0] < src.handed[k + 1], k
    for k, (seen, arrival, _) in enumerate(got):
        assert src.handed[k] <= arrival <= seen


def test_every_pull_runs_on_the_consumers_thread():
    src = LiveSource(frames(3), 0.01)
    assert len(list(device_frames(src, CPU))) == 3
    assert src.threads == {threading.get_ident()}


def test_a_reused_buffer_yields_each_frames_bytes():
    def reusing(n):
        buf = np.zeros((4, 4, 4), dtype=np.uint8)
        for i in range(n):
            buf[:] = i      # the source overwrites its one buffer
            yield buf

    got = [codes(dev) for dev, _ in device_frames(reusing(12), CPU)]
    assert got == [{i} for i in range(12)]


@pytest.mark.parametrize("period", [0.0, 0.02])
def test_a_source_error_is_raised_after_the_frames_before_it(period):
    def failing():
        yield from LiveSource(frames(3), period)
        raise OSError("source failed")

    got = []
    with pytest.raises(OSError, match="source failed"):
        for dev, _ in device_frames(failing(), CPU):
            got.append(codes(dev))
    assert got == [{0}, {1}, {2}]


@pytest.mark.parametrize("taken", [0, 1, 3])
def test_stopping_early_reads_the_source_no_further(taken):
    src = ReadySource(frames(6))
    ring = device_frames(src, CPU)
    for _ in range(taken):
        next(ring)
    ring.close()
    assert len(src.handed) == taken


def test_an_empty_source_yields_nothing():
    assert list(device_frames(iter([]), CPU)) == []
