"""Tracing, profiling and the NaN guard.

Counterpart of ``tpufg/utils/tracing.py``: named spans at each boundary a
frame crosses in the engine (``annotate``; free while no profiler session
is on), a context manager that captures a profiler trace of the card and
the host (``trace_session``, the CLI's ``--trace DIR``), the reader of the
spans' device durations in such a trace (``module_durations_ms``) and the
NaN guard of ``--debug-checks`` (``debug_checks``, tpufg's
``jax_debug_nans``).

Usage:
    with trace_session("trace-dir"):   # or CLI --trace DIR
        ...
    with annotate("tpufg.step"):
        ...
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

_TRACE_SUFFIX = ".trace.json.gz"


@contextlib.contextmanager
def trace_session(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host, and the CUDA device where
    there is one) into ``log_dir`` as a gzipped Chrome trace,
    ``<time>.<pid>.trace.json.gz``; a no-op for None."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        name = f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}"
        with tempfile.TemporaryDirectory() as tmp:
            raw = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as src, gzip.open(
                    os.path.join(log_dir, name + _TRACE_SUFFIX), "wb") as dst:
                shutil.copyfileobj(src, dst)


# what ``annotate`` returns while no profiler session is on
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span in the profiler timeline (host, and the device's work
    the span launches), the program's only way to open one.  The span is
    recorded only while a profiler session is on (``trace_session``, or
    any ``torch.profiler`` session around the call); otherwise this
    returns one shared no-op context manager, so an unprofiled span costs
    a flag read and enters no ``record_function``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def module_durations_ms(trace_dir: str) -> dict:
    """Per-invocation DEVICE durations (ms) of every annotated span in the
    newest trace under ``trace_dir``, keyed by span name.

    A span's device duration is Kineto's ``gpu_user_annotation`` event for
    it; where a trace has none, it is first kernel start to last kernel
    end of the kernels the span's launches made (matched by correlation
    id).  Returns {} when the trace records no device work (a CPU-only
    run) or there is no trace."""
    files = glob.glob(os.path.join(trace_dir, "**", "*" + _TRACE_SUFFIX),
                      recursive=True)
    if not files:
        return {}
    with gzip.open(sorted(files)[-1], "rt") as f:
        ev = json.load(f)
    events = [e for e in ev.get("traceEvents", []) if e.get("ph") == "X"]
    durs: dict = {}
    gpu = [e for e in events if e.get("cat") == "gpu_user_annotation"]
    if gpu:
        for e in gpu:
            durs.setdefault(e.get("name", ""), []).append(
                e.get("dur", 0) / 1e3)  # us -> ms
        return durs
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
            kernels[e["args"]["correlation"]] = (e["ts"], e["ts"] + e["dur"])
    launches = sorted(
        (e["ts"], e["args"]["correlation"]) for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and e.get("args", {}).get("correlation") in kernels)
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
        spans = [kernels[c] for ts, c in launches if lo <= ts <= hi]
        if spans:
            durs.setdefault(e.get("name", ""), []).append(
                (max(s[1] for s in spans) - min(s[0] for s in spans)) / 1e3)
    return durs


# ops whose output is not a computed value: uninitialised memory and views
_UNCHECKED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided, torch.ops.aten.resize_,
              torch.ops.aten.set_}


class _NanGuard(TorchDispatchMode):
    """Raises FloatingPointError at the first op whose floating output
    holds a NaN (each check reads the output back: it synchronises)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _UNCHECKED or func.is_view:
            return out
        for t in _pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def nan_guard_active() -> bool:
    """Whether the current thread runs inside ``debug_checks(True)``."""
    return any(isinstance(m, _NanGuard)
               for m in _get_current_dispatch_mode_stack())


@contextlib.contextmanager
def debug_checks(enabled: bool) -> Iterator[None]:
    """NaN guard for every computation in scope (tpufg's
    ``jax_debug_nans``): torch's ops through a dispatch mode, the port's
    CUDA kernels, whose launches bypass the dispatcher, in
    ``kernels.common.launch`` (:func:`nan_guard_active`).  Off by default;
    it synchronises at every op while on."""
    if not enabled:
        yield
        return
    with _NanGuard():
        yield
