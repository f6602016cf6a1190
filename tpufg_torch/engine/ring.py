"""Prefetched host -> device frame ingest.

Counterpart of ``tpufg/engine/ring.py``.  The next ``depth`` frames are
copied into pinned host memory and queued as asynchronous
(``non_blocking``) copies to the device ahead of consumption, so the host
never waits for an upload.  The copies run on the current stream, in
order with the compute; a side copy stream that overlaps them with the
kernels is later work.

The pinned copy is made synchronously, before the source iterator
advances, so zero-copy slot sources (whose buffer is recycled on the next
read) are safe without any extra wait; PyTorch keeps the pinned block
alive until its queued copy has run.

Each frame's pin copy and upload is the ``tpufg.ingest`` span, opened once
the frame has been received (the source's own wait is outside it); the
frame's arrival, on ``time.perf_counter``, is kept beside its slot.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from tpufg_torch.utils.tracing import annotate


class DeviceIngestRing:
    """Wraps a frame iterator; yields ``(tensor on device, arrival)``
    pairs, each tensor uploaded ahead of time and ``arrival`` the
    ``time.perf_counter()`` at which the source handed the frame over."""

    def __init__(self, frames: Iterable[np.ndarray], device: torch.device,
                 depth: int = 2):
        if depth < 1:
            raise ValueError("ring depth must be >= 1")
        self._it: Iterator[np.ndarray] = iter(frames)
        self._device = torch.device(device)
        self._depth = depth
        self._q: collections.deque = collections.deque()

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(frame))
        if self._device.type == "cpu":
            return host.clone()  # own the bytes: the source may reuse them
        return host.pin_memory().to(self._device, non_blocking=True)

    def _fill(self) -> None:
        while len(self._q) < self._depth:
            try:
                frame = next(self._it)
            except StopIteration:
                return
            arrival = time.perf_counter()
            with annotate("tpufg.ingest"):
                self._q.append((self._upload(frame), arrival))

    def __iter__(self):
        self._fill()
        while self._q:
            out = self._q.popleft()
            self._fill()
            yield out
