"""The traced run: a ``torch.profiler`` session over the window, read back
from its Chrome trace into the records the per-layer readers take.

The session records the host and the card (kernels, copies, fills, and the
program's named spans, ``tpufg.step`` and ``tpufg.readback``), besides the
benchmark's own spans around its calls into the engine (``fgbench.window``
around the window, ``fgbench.source_wait`` and ``fgbench.sink``).  It waits
50 ms on the host after it starts and before it stops: the profiler has
dropped device records at a session's edges on the H100.  The trace is
written into a temporary directory (``TMPDIR``), read and deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "fgbench.window"
EDGE_WAIT_S = 0.05
# device activities of the trace, by their Chrome trace category
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """What a traced window recorded, times in seconds on the trace's
    clock: device activities as (name, start, duration) by category, host
    spans as (start, duration) by name, the window's (start, duration),
    and what the benchmark counted in it."""

    device: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    window: tuple = (0.0, 0.0)
    frames_in: int = 0
    cell: dict = field(default_factory=dict)

    def kernels(self, part: str = "") -> list:
        return [r for r in self.device.get("kernel", []) if part in r[0]]

    def copies(self, *kinds: str) -> list:
        return [r for r in self.device.get("gpu_memcpy", [])
                if any(k in r[0] for k in kinds)]

    def span_total_s(self, name: str) -> float:
        return sum(d for _, d in self.spans.get(name, []))

    def busy_intervals(self) -> list:
        """The union of every device activity's interval inside the
        window, as sorted disjoint (start, end)."""
        lo, dur = self.window
        hi = lo + dur
        iv = sorted((max(s, lo), min(s + d, hi))
                    for cat in DEVICE_CATS
                    for _, s, d in self.device.get(cat, [])
                    if s + d > lo and s < hi)
        out: list = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())


def parse(events: list) -> Trace:
    """A Chrome trace's events (times in us) -> :class:`Trace`."""
    t = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = e.get("ts", 0) / 1e6, e.get("dur", 0) / 1e6
        if cat in DEVICE_CATS:
            t.device.setdefault(cat, []).append((name, ts, dur))
        elif cat == "user_annotation":
            if name == WINDOW_SPAN:
                t.window = (ts, dur)
            else:
                t.spans.setdefault(name, []).append((ts, dur))
    return t


@contextlib.contextmanager
def session(out: list):
    """Profile the block (host and card) and append its :class:`Trace` to
    ``out``; the block runs inside the ``fgbench.window`` span."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        time.sleep(EDGE_WAIT_S)
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(EDGE_WAIT_S)
    finally:
        prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out.append(parse(events))


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time inside the window, summed by the host span the
    idle gap's middle falls in (the innermost one), with the count and
    the longest gap of each; seconds, at most ``top`` entries each."""
    ops: dict = {}
    for cat in DEVICE_CATS:
        for name, _, d in t.device.get(cat, []):
            ops[name[:120]] = ops.get(name[:120], 0.0) + d
    busy = t.busy_intervals()
    lo, dur = t.window
    edges = [lo] + [x for iv in busy for x in iv] + [lo + dur]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    # per span name its spans by start: a gap's middle is looked up in each
    by_name = {n: sorted((s, s + d) for s, d in lst)
               for n, lst in t.spans.items()}
    starts = {n: [s for s, _ in lst] for n, lst in by_name.items()}
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        name, inner = "outside the named spans", float("inf")
        for n, lst in by_name.items():
            k = bisect.bisect_right(starts[n], mid) - 1
            if k >= 0 and lst[k][1] >= mid and lst[k][1] - lst[k][0] < inner:
                name, inner = n, lst[k][1] - lst[k][0]
        tot, cnt, longest = idle.get(name, (0.0, 0, 0.0))
        idle[name] = (tot + (b - a), cnt + 1, max(longest, b - a))
    return {
        "device_ops": sorted(([n, s] for n, s in ops.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([f"{n} ({c} gaps, longest {m:.6f} s)", s]
                             for n, (s, c, m) in idle.items()),
                            key=lambda r: -r[1])[:top],
    }
