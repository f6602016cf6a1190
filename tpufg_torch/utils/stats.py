"""Runtime statistics for the port: FPS sliding window, latency
percentiles and the device sync.

``FpsWindow`` and ``LatencyRecorder`` are copies of
``tpufg/utils/stats.py``'s.  ``FpsWindow`` reproduces the reference's
60-sample sliding-window FPS estimator (reference src/scaler.cpp:428-439):
push a timestamp per frame, drop to the newest ``window`` samples, and
report ``(n_samples - 1) / (newest - oldest)``.  ``LatencyRecorder``
records per-frame latencies and reports p50/p90/p99; the engine feeds it
each input frame's time in the program, from its arrival at the ingest
ring to its last output handed to the sink.

``device_sync`` is the torch counterpart of tpufg's, whose one-element
numpy fetch does not apply to CUDA tensors.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Optional

import torch


class FpsWindow:
    def __init__(self, window: int = 60):
        if window < 2:
            raise ValueError("fps window must hold at least 2 samples")
        self.window = window
        self._times: Deque[float] = collections.deque(maxlen=window)

    def tick(self, now: Optional[float] = None) -> None:
        self._times.append(time.perf_counter() if now is None else now)

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        if span <= 0:
            return 0.0
        return (len(self._times) - 1) / span


def device_sync(x: torch.Tensor) -> None:
    """Wait until the work queued on ``x``'s current CUDA stream is done
    (a no-op for CPU tensors, which are computed synchronously)."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


class LatencyRecorder:
    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._samples: Deque[float] = collections.deque(maxlen=capacity)

    def record(self, seconds: float) -> None:
        self._samples.append(seconds)

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, q in [0, 100]."""
        if not self._samples:
            return 0.0
        data = sorted(self._samples)
        if q <= 0:
            return data[0]
        if q >= 100:
            return data[-1]
        rank = max(1, int(round(q / 100.0 * len(data) + 0.5)))
        return data[min(rank, len(data)) - 1]

    def summary(self) -> dict:
        if not self._samples:
            return {"n": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0}
        return {
            "n": len(self._samples),
            "mean_ms": 1e3 * sum(self._samples) / len(self._samples),
            "p50_ms": 1e3 * self.percentile(50),
            "p90_ms": 1e3 * self.percentile(90),
            "p99_ms": 1e3 * self.percentile(99),
        }
