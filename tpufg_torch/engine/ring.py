"""Host -> device frame ingest.

Counterpart of ``tpufg/engine/ring.py``, which queues ``depth`` frames
ahead.  Here a frame is pulled from the source only when the engine asks
for it, copied into pinned host memory, queued as an asynchronous
(``non_blocking``) copy to the device and yielded at once: no frame is
held ahead, so a frame from a live source never waits for later ones to
arrive.  The copies run on the current stream, in order with the compute,
so an upload queued ahead of time would only have run ahead of the step
before it.

The pinned copy is made before the source iterator advances, so zero-copy
slot sources (whose buffer is recycled on the next read) are safe without
any extra wait; PyTorch keeps the pinned block alive until its queued copy
has run.

Each frame's pin copy and upload is the ``tpufg.ingest`` span, opened once
the frame has been received; the engine's wait for the source's next frame
is the ``tpufg.ring.arrival_wait`` span.  The frame's arrival, on
``time.perf_counter``, is yielded beside it.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

import numpy as np
import torch

from tpufg_torch.utils.tracing import annotate


def _upload(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(frame))
    if device.type == "cpu":
        return host.clone()  # own the bytes: the source may reuse them
    return host.pin_memory().to(device, non_blocking=True)


def device_frames(frames: Iterable[np.ndarray], device: torch.device
                  ) -> Iterator[tuple[torch.Tensor, float]]:
    """Yields ``(tensor on device, arrival)`` for each frame of
    ``frames``, ``arrival`` the ``time.perf_counter()`` at which the
    source handed the frame over."""
    device = torch.device(device)
    it = iter(frames)
    while True:
        with annotate("tpufg.ring.arrival_wait"):
            frame = next(it, None)
        if frame is None:
            return
        arrival = time.perf_counter()
        with annotate("tpufg.ingest"):
            dev = _upload(frame, device)
        yield dev, arrival
