"""One run of one cell: set-up, the measured window, the check.

The window drives the port's served path as ``python -m tpufg_torch.cli``
builds it: a ``StreamingEngine`` from the configuration's settings, whose
``run(source, sink, paced=...)`` takes the benchmark's source and sink
(``fgbench/load.py``).  Set-up makes the bank from the seed, builds the
engine and runs it once over ``warm_frames`` frames of the bank with the
cell's own sink wire and pacing, which builds the kernel library (the
first run in a checkout) and builds and calls the cell's steps; nothing
else is warmed.  Then the window: ``seconds``
(``trace_seconds`` of the traffic file in a traced run, under the
profiler).  Once it has closed, the device's peak memory is read, the
engine is freed, and the reference checks a seeded sample of what the
sink received (``fgbench/check.py``).

The traffic file's keys: ``fps`` (the open loop's rate; 0 for a closed
loop), ``paced`` (the engine's own pacing), ``sink_wire`` ("rgba",
"y4m420" or "y4m444"), ``bank_frames``, ``max_speed`` (the pan's largest
step, px a frame), ``warm_frames``, ``check_frames`` (the sample's size)
and ``trace_seconds``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import resource
import time

import torch

from fgbench import check, load, trace
from fgbench.reference.steps import make_reference
from fgbench.spec import ROOT, Cell


def process_age_s() -> float:
    """Seconds since this process started (Linux: from /proc, 10 ms
    ticks), else since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def host_state() -> dict:
    """This process's CPU seconds, and the host's CPU pressure where Linux
    reports it: read before and after the window, so that a slow run shows
    what held the host."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}
    try:
        with open("/proc/pressure/cpu") as f:
            # "some avg10=.. avg60=.. avg300=.. total=<us>"
            out["cpu_some_us"] = int(f.readline().rsplit("=", 1)[1])
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_delta(before: dict, after: dict) -> dict:
    """What the window took of the host: CPU seconds (five to six in a
    second mean the cores were spinning), the seconds some thread waited
    for a core, the cores this process may use and torch's threads."""
    d = {k: after[k] - before[k] for k in before if k in after}
    out = {k: d[k] for k in ("user_s", "sys_s")}
    if "cpu_some_us" in d:
        out["cpu_pressure_s"] = d["cpu_some_us"] / 1e6
    out["cpus"] = len(os.sched_getaffinity(0))
    out["threads"] = torch.get_num_threads()
    return out


def per_second(times: list, t0: float, seconds: float) -> list:
    """Outputs that arrived in each whole second of the window."""
    n = max(1, int(seconds))
    counts = [0] * n
    for t in times:
        s = int(t - t0)
        if t >= t0 and s < n:
            counts[s] += 1
    return counts


@dataclasses.dataclass
class Record:
    """What the end-to-end readers take: the window's start ``t0`` and
    length on the host clock, the source and sink of the window, and the
    set-up time."""

    t0: float
    seconds: float
    source: load.BankSource
    sink: load.RecordingSink
    setup_s: float


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, root: str = ROOT) -> dict:
    """Run ``cell`` once; returns the result's keys (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, and ``check``, the compared numbers with their limits)."""
    from tpufg_torch.config import EngineConfig
    from tpufg_torch.engine.runner import StreamingEngine
    from tpufg_torch.models import rife

    cfg, tr = cell.config, cell.traffic
    eng_cfg = EngineConfig(**cfg["engine"]).validate()
    paced, fps = bool(tr["paced"]), float(tr["fps"])
    if fps > 0:
        # the CLI's rule: the engine paces at the source's frame rate
        eng_cfg.target_fps = max(1, round(fps))
    k = eng_cfg.fps_multiplier
    cuda = device.type == "cuda"
    bank = load.make_bank(seed, eng_cfg.input_height, eng_cfg.input_width,
                          tr["bank_frames"], tr["max_speed"], device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = (rife.load_params(os.path.join(root, cfg["checkpoint"]))
             if cfg.get("checkpoint") else None)
    engine = StreamingEngine(eng_cfg, precision=cfg.get("precision", "fast"),
                             device=device, model_params=model)
    engine.run(load.BankSource(bank, count=tr["warm_frames"]),
               load.RecordingSink(tr["sink_wire"], k), paced=paced)
    if cuda:
        torch.cuda.synchronize(device)

    window_s = min(seconds, tr["trace_seconds"]) if traced else seconds
    span = (torch.profiler.record_function if traced
            else contextlib.nullcontext)
    count = round(window_s * fps) if fps > 0 else None
    source = load.BankSource(
        bank, fps=fps, count=count,
        seconds=None if fps > 0 else window_s, span=span)
    sink = load.RecordingSink(
        tr["sink_wire"], k, check.Sample(seed, tr["check_frames"], count),
        span)
    traces: list = []
    before = host_state()
    with trace.session(traces) if traced else contextlib.nullcontext():
        engine.run(source, sink, paced=paced)
    t_end = time.perf_counter()
    host = host_delta(before, host_state())
    record = Record(t0=source.t0, seconds=window_s, source=source, sink=sink,
                    setup_s=process_age_s() - (t_end - source.t0))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)}
    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    breakdown = None
    if traced:
        t = traces[0]
        t.frames_in = source.offered
        t.cell = {"engine": cfg["engine"], "root": root,
                  "checkpoint": cfg.get("checkpoint")}
        entries = cell.per_layer
        dev["busy_s"], dev["window_s"] = t.busy_s(), t.window[1]
        breakdown = trace.breakdown(t)
    else:
        t = record
        entries = cell.end_to_end
    for m, read in entries:
        v = read(t)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    reference = make_reference(cfg, "bf16", device, root)
    numbers = check.compare(sink.kept, sink.wire_format, bank,
                            reference, device)
    numbers["missing_frames"] += source.offered - sink.delivered()
    correct, rows = check.verdict(numbers, cfg["limits"])
    out = {"correct": correct, "attempted": source.offered,
           "failed": source.offered - sink.delivered(), "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {"frames_compared": numbers["frames_compared"],
                   "bytes_compared": numbers["bytes_compared"],
                   "max_code_gap": numbers["max_code_gap"],
                   "source_late_s": source.late_s, "window_s": window_s,
                   "host": host,
                   "outputs_per_s": per_second(sink.times, source.t0,
                                               window_s)}
    out["check"] = rows
    return out
