"""Arithmetic the metric readers share.

An end-to-end reader takes a ``harness.Record`` (the window on the host
clock), a per-layer reader a ``trace.Trace`` (the traced window); each
returns a number, or None where the run has nothing to read.
"""

from __future__ import annotations

import numpy as np


def latencies_ms(r) -> np.ndarray:
    """Per input frame of the window: from when it was due to when the
    sink held its last output, in ms (every frame the source offered)."""
    src, sink = r.source, r.sink
    n = min(src.offered, sink.delivered())
    return np.array([(sink.arrival(i) - src.due(i)) * 1e3
                     for i in range(n)])


def percentile_ms(r, q: float):
    if r.source.fps <= 0:
        return None
    lat = latencies_ms(r)
    return float(np.percentile(lat, q)) if len(lat) else None


def per_frame_ms(t, seconds: float):
    """``seconds`` of the traced window spread over its input frames."""
    return seconds / t.frames_in * 1e3 if t.frames_in else None


def kernel_share_pct(t, part: str, bound_s: float):
    """``bound_s`` over the mean device time of the kernels whose name
    holds ``part``, in % (None where no such kernel ran)."""
    ks = t.kernels(part)
    if not ks:
        return None
    return bound_s / (sum(d for _, _, d in ks) / len(ks)) * 100.0
