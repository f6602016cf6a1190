"""Streaming engine: source -> device ring -> step -> sink.

Counterpart of ``tpufg/engine/runner.py`` (``StreamingEngine``,
``run_stream``).  Each frame's step is queued on the card and its
outputs are handed to the sink at once, before the next frame is pulled
from the source: the engine waits on the source only with no work left.
Uploads, steps and readbacks share one stream, so a hand-over held back
until the next frame's step is queued (tpufg's one-slot pipeline) would
overlap nothing on the device, and delays a live frame by a period.
Pacing runs on an absolute-deadline clock, and stats keep a
sliding-window fps and percentiles of each frame's time in the program.
Frames cross the host boundary as the packed-int32 wire (a free view of
the uint8 bytes).

The engine runs on CUDA by default and raises when no CUDA device is
available; the CPU is used only when a caller passes it explicitly.  A
learned head (``model_params``) runs the step with its stream cache: the
first pair is seeded by ``make_q_init``, and each step's cache for curr
seeds the next pair.  ``--temporal-mv`` threads the MV field the same way,
on the device from zeros.  Each pair emits k - 1 in-between frames and
curr (``--fps-multiplier`` k), in time order.  A y4m sink takes its FRAME
payloads converted on the device (``kernels/yuv.py``) unless the overlay,
which draws on host RGBA, is on.  ``precision="exact"`` runs the oracle's
steps (``make_exact_scale_step`` and the exact ``make_interp_step``) on the
uint8 wire and always reads RGBA back.

Under a profiler session (``utils/tracing.py``) each frame's path is tiled
by named spans: ``tpufg.ingest`` (the ring's pin copy and upload),
``tpufg.step`` (with the fast interpolating step's stages inside it,
``tpufg.step.unpack``, ``.motion`` or ``.head``, ``.warp``, ``.scale``
where it runs eagerly, ``tpufg.step.graph`` where a graph replays it) and
``tpufg.readback`` (the hand-over of its outputs to the sink),
``tpufg.readback.refill`` (the top-up of the pinned blocks after it), and
``tpufg.ring.arrival_wait`` while the engine waits for the source's next
frame.  The k-th span of each of ``tpufg.ingest``, ``tpufg.step`` and
``tpufg.readback`` in one ``run`` belongs to input frame k.
The latency recorder holds each frame's time in the program, from its
arrival at the ring to its last output handed to the sink.

Where the engine waits: a sink that takes host arrays (``needs_host``)
gets each frame's outputs read back on a CUDA device through page-locked
blocks of torch's caching host allocator (``HostReadback``): the copies
are queued on the current stream after the step, and the engine waits
once a frame, on an event recorded after the last of them, before the
first output is handed over.  The blocks are the sink's to keep; the
allocator takes one back only when nothing holds it or a view of it.
Once the frame is handed over, the cache is topped up with as many
blocks as a frame's outputs take, so that a ``cudaHostAlloc`` runs while
the engine has nothing else to do and not inside a frame's hand-over.  A
sink that takes device tensors (``NullSink``) is synchronised every
frame when paced, every 8th frame unpaced, which bounds the launch
queue.  On the CPU the outputs are host tensors already and are handed
over as they are.

On a CUDA device a fast interpolating step that threads no state between
pairs (no ``--temporal-mv``, no learned stream cache) runs as the replay
of one CUDA graph (``engine/graph.py``): its outputs are the graph's,
overwritten by the next pair's replay, so a sink that takes them as they
are (a device sink) is handed clones.  ``StreamStats.graph_captures`` and
``graph_replays`` count it.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.graph import CudaGraphs, GraphedStep
from tpufg_torch.engine.overlay import draw_stats
from tpufg_torch.engine.pipeline import (check_ported, is_temporal,
                                         make_exact_scale_step,
                                         make_interp_step, make_q_init,
                                         make_scale_step, mv_lattice_shape)
from tpufg_torch.engine.ring import device_frames
from tpufg_torch.io.native import NativeClock
from tpufg_torch.io.sinks import FrameSink
from tpufg_torch.io.sources import FrameSource
from tpufg_torch.kernels.common import resolve_device
from tpufg_torch.kernels.yuv import y4m_wire_ok
from tpufg_torch.models.rife import params_to_torch
from tpufg_torch.utils.logging import get_logger
from tpufg_torch.utils.stats import (FpsWindow, LatencyRecorder,
                                     device_sync)
from tpufg_torch.utils.tracing import annotate


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    fps: float = 0.0
    latency: dict = field(default_factory=dict)
    # paced mode: input frames measured against their absolute deadline
    # (the first frames are excluded — the clock re-anchors after them)
    paced_frames: int = 0
    deadline_misses: int = 0
    # outputs handed over from pinned host blocks (HostReadback), and the
    # blocks the caching host allocator had to make inside a frame's
    # hand-over and inside the top-up after it
    readback_pinned: int = 0
    readback_host_allocs: int = 0
    refill_host_allocs: int = 0
    # the stateless fast step's CUDA graph (engine/graph.py): graphs
    # captured, and pairs run by replaying one
    graph_captures: int = 0
    graph_replays: int = 0


def _i32_view(frames):
    """uint8 [H, W, 4] frames -> packed int32 [H, W] views (same bytes)."""
    for f in frames:
        if not f.flags["C_CONTIGUOUS"]:
            f = np.ascontiguousarray(f)
        yield f.view(np.int32).reshape(f.shape[0], f.shape[1])


def _as_u8(a: np.ndarray) -> np.ndarray:
    """The packed-int32 wire -> uint8 [H, W, 4] (a free view of the same
    bytes); a y4m payload (uint8 [rows, W]) passes unchanged."""
    if a.dtype == np.int32:
        return a.view(np.uint8).reshape(a.shape[0], a.shape[1], 4)
    return a


class PinnedHost:
    """Page-locked host blocks from torch's caching host allocator, and
    the count of blocks it has made with ``cudaHostAlloc`` (cache misses,
    ``num_host_alloc`` of ``torch.cuda.host_memory_stats``)."""

    @staticmethod
    def empty(shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    @staticmethod
    def allocs() -> int:
        return torch.cuda.host_memory_stats_as_nested_dict()["num_host_alloc"]


class HostReadback:
    """Reads each frame's outputs back into blocks of ``host``
    (``PinnedHost``; a test passes another with its two calls).

    ``read`` queues each output's copy into a block of its shape and
    dtype on the current stream, records one event after the last copy
    and waits on it, then returns each block as a numpy array (uint8
    RGBA for the packed wire), in the outputs' order.  The blocks are the
    caller's: a block goes back to the allocator's cache only when
    nothing holds it or a view of it, so none is written again while a
    sink keeps it.  ``refill(n)`` then takes ``n`` blocks of the last
    output's shape at once and drops them: cache hits where the cache
    holds them, else ``cudaHostAlloc`` calls made there, so that the next
    frame's ``read`` finds its blocks cached.  The counters count the
    outputs read and the blocks ``host`` made inside each call."""

    def __init__(self, host):
        self.host = host
        self._last = None  # (shape, dtype) of the last output read
        self.pinned = self.read_allocs = self.refill_allocs = 0

    def read(self, outs) -> list:
        allocs = self.host.allocs()
        blocks = [self.host.empty(t.shape, t.dtype) for t in outs]
        for b, t in zip(blocks, outs):
            b.copy_(t, non_blocking=True)
        if outs[-1].is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(outs[-1].device))
            done.synchronize()
        self.read_allocs += self.host.allocs() - allocs
        self.pinned += len(blocks)
        self._last = (blocks[-1].shape, blocks[-1].dtype)
        return [_as_u8(b.numpy()) for b in blocks]

    def refill(self, n: int) -> None:
        allocs = self.host.allocs()
        blocks = [self.host.empty(*self._last) for _ in range(n)]
        del blocks
        self.refill_allocs += self.host.allocs() - allocs


class StreamingEngine:
    def __init__(self, cfg: EngineConfig, precision: str = "fast",
                 device: torch.device | str | None = None,
                 model_params=None):
        cfg.validate()
        check_ported(cfg, precision, model_params)
        self.cfg = cfg
        self.exact = precision == "exact"
        self.device = resolve_device(device)
        # the learned head's stream cache threads between pairs (the exact
        # path takes the head and runs the oracle's search instead)
        self._qfeed = (cfg.enable_interpolation and not self.exact
                       and cfg.motion_mode == "learned")
        self.model_params = (params_to_torch(model_params, self.device)
                             if self._qfeed and model_params is not None
                             else model_params)
        # where a host sink's outputs are read back to: pinned blocks on a
        # CUDA device; None on the CPU, whose outputs are host tensors
        self._host = PinnedHost if self.device.type == "cuda" else None
        # how a stateless fast step is captured and replayed: CUDA graphs
        # on a CUDA device; None on the CPU, whose step runs eagerly
        self._graphs = CudaGraphs if self.device.type == "cuda" else None
        self._graph = None  # the GraphedStep that _step2 runs, if any
        self.log = get_logger()
        self._built = None  # (sink wire, motion_skip_alpha) of the steps
        self._fps_win = FpsWindow(cfg.fps_window)

    def _sink_wire(self, sink: FrameSink) -> str:
        """The output wire: a y4m sink takes FRAME payloads converted on
        the device (``kernels/yuv.py``, byte for byte the host egress's)
        where the dimensions allow it and no overlay is drawn (the
        overlay draws on host RGBA); every other sink, and the exact
        path, takes RGBA."""
        wf = getattr(sink, "wire_format", "rgba")
        if (wf in ("y4m420", "y4m444") and not self.cfg.overlay
                and not self.exact
                and y4m_wire_ok(self.cfg.output_height,
                                self.cfg.output_width, wf[3:])):
            return wf
        return "rgba"

    def _build_steps(self, sink_wire: str, skip_alpha: bool) -> None:
        if self._built == (sink_wire, skip_alpha):
            return
        cfg = self.cfg
        self._graph = None
        if self.exact:
            # the oracle speaks uint8 frames and RGBA out
            if cfg.enable_interpolation:
                self._step2 = make_interp_step(cfg, "exact",
                                               device=self.device,
                                               model_params=self.model_params)
            self._step1 = make_exact_scale_step(cfg, self.device)
            self._built = (sink_wire, skip_alpha)
            return
        if cfg.enable_interpolation:
            self._step2 = make_interp_step(cfg, wire="i32",
                                           sink_wire=sink_wire,
                                           motion_skip_alpha=skip_alpha,
                                           device=self.device,
                                           model_params=self.model_params,
                                           q_feed=self._qfeed)
            # a step that threads no state between pairs makes the same
            # launches on the same shapes every pair: one graph replays
            # them (frame 0's scale step stays eager)
            if (self._graphs is not None and not is_temporal(cfg)
                    and not self._qfeed):
                self._graph = GraphedStep(self._step2, self._graphs)
                self._step2 = self._graph
            if self._qfeed:
                self._q_init = make_q_init(cfg, self.model_params,
                                           self.device)
        self._step1 = make_scale_step(cfg, wire="i32", sink_wire=sink_wire,
                                      device=self.device)
        self._built = (sink_wire, skip_alpha)

    def run(self, source: FrameSource, sink: FrameSink,
            max_frames: Optional[int] = None, paced: bool = True,
            start_frame: int = 0) -> StreamStats:
        """Stream ``source`` into ``sink``.  ``start_frame`` skips that
        many source frames first; the stream restarts there, re-emitting
        that frame scaled."""
        cfg = self.cfg
        stats = StreamStats()
        # a source whose alpha is one constant lets motion search drop it
        self._build_steps(self._sink_wire(sink),
                          getattr(source, "const_alpha", None) is True)
        frames = iter(source)
        for _ in range(start_frame):
            if next(frames, None) is None:
                break
        if max_frames is not None:
            # the source is read no further than the frames the run takes
            frames = itertools.islice(frames, max(0, max_frames))
        frame_period = 1.0 / cfg.target_fps if cfg.target_fps > 0 else 0.0
        needs_host = getattr(sink, "needs_host", True)
        prev_dev = None
        q_state = None  # the learned step's cache of prev
        temporal = not self.exact and is_temporal(cfg)
        # the temporal MV seed stays on the device, zeros for the first pair
        mv_state = (torch.zeros(mv_lattice_shape(cfg), dtype=torch.float32,
                                device=self.device) if temporal else None)
        # each frame's time in the program, kept for the last run
        self._lat = lat = LatencyRecorder()

        readback = (HostReadback(self._host)
                    if needs_host and self._host is not None else None)
        graph = self._graph
        graphed_from = ((graph.captures, graph.replays) if graph is not None
                        else (0, 0))
        per_frame = cfg.fps_multiplier if cfg.enable_interpolation else 1

        def hand_over(outs, arrival):
            # k - 1 in-between frames, then curr: the step's order is time
            if needs_host:
                outs = (readback.read(outs) if readback is not None
                        else [_as_u8(t.numpy()) for t in outs])
            for out in outs:
                if needs_host and cfg.overlay:
                    # drawn in place: on the pinned block the engine owns,
                    # else on a copy (a CPU step may return its input)
                    out = draw_stats(
                        out if readback is not None else np.array(out),
                        self._fps_win.fps,
                        (cfg.input_width, cfg.input_height),
                        (cfg.output_width, cfg.output_height))
                sink.write(out)  # a device sink takes the tensors
                stats.frames_out += 1
            lat.record(time.perf_counter() - arrival)

        t_start = time.perf_counter()
        clock = None
        if paced and frame_period > 0:
            clock = NativeClock(float(cfg.target_fps))
        ring = device_frames(frames if self.exact else _i32_view(frames),
                             self.device)
        try:
            for dev, arrival in ring:
                with annotate("tpufg.step"):
                    if cfg.enable_interpolation and prev_dev is not None:
                        if temporal:
                            *outs, mv_state = self._step2(prev_dev, dev,
                                                          mv_state)
                        elif self._qfeed:
                            if q_state is None:
                                q_state = self._q_init(prev_dev)
                            *outs, q_state = self._step2(prev_dev, dev,
                                                         q_state)
                        else:
                            outs = list(self._step2(prev_dev, dev))
                            if graph is not None and readback is None:
                                # the next replay overwrites the graph's
                                # outputs: a sink that keeps them as they
                                # are handed over gets its own
                                outs = [o.clone() for o in outs]
                    else:
                        outs = [self._step1(dev)]
                with annotate("tpufg.readback"):
                    hand_over(outs, arrival)
                if readback is not None:
                    # as many blocks as each later frame's outputs take
                    with annotate("tpufg.readback.refill"):
                        readback.refill(per_frame)
                prev_dev = dev
                stats.frames_in += 1
                # a host sink's hand-over waited on the frame's copies; a
                # device sink's frames are synchronised every frame when
                # paced, so that the deadline is met by finished work, and
                # every 8th unpaced, which bounds the launch queue
                if not needs_host and (paced or stats.frames_in % 8 == 3):
                    device_sync(outs[-1])
                self._fps_win.tick()
                if stats.frames_in % 60 == 0:
                    self.log.info(f"Processing frame {stats.frames_in}, "
                                  f"fps: {self._fps_win.fps:.1f}")
                if clock is not None:
                    late = clock.pace()
                    if stats.frames_in <= 2:
                        clock.reset()
                    else:
                        stats.paced_frames += 1
                        if late > 0:
                            stats.deadline_misses += 1
                        if late > frame_period:
                            # a whole frame behind: the missed slots are
                            # dropped and the schedule resumes from now
                            clock.reset()
                    if late > 0.1 and stats.frames_in > 2:
                        self.log.warning(f"frame {stats.frames_in} late by "
                                         f"{late * 1e3:.1f} ms")
        finally:
            if clock is not None:
                clock.close()
        wall = time.perf_counter() - t_start
        stats.fps = stats.frames_in / wall if wall > 0 else 0.0
        stats.latency = lat.summary()
        if graph is not None:
            stats.graph_captures = graph.captures - graphed_from[0]
            stats.graph_replays = graph.replays - graphed_from[1]
        if readback is not None:
            stats.readback_pinned = readback.pinned
            stats.readback_host_allocs = readback.read_allocs
            stats.refill_host_allocs = readback.refill_allocs
        if readback is not None or graph is not None:
            self.log.info(f"{stats.frames_in} frames, fps: {stats.fps:.1f}; "
                          f"{stats.readback_pinned} outputs read back "
                          f"pinned, host blocks made: "
                          f"{stats.readback_host_allocs} in the hand-over, "
                          f"{stats.refill_host_allocs} in the top-up; "
                          f"graph_captures {stats.graph_captures}, "
                          f"graph_replays {stats.graph_replays}")
        return stats


def measure_step_rate(cfg: EngineConfig, n: int = 6,
                      device: torch.device | str | None = None) -> float:
    """Measured steady-state rate of cfg's interpolation step, in frame
    PAIRS per second (``--quality auto``'s headroom check; tpufg's
    ``measure_step_rate``).  Builds the step on ``device`` (CUDA unless
    given), runs one synchronised warm-up pair (which builds the kernels
    and is not timed), then times ``n`` pairs queued back to back with one
    synchronisation at the end, on the host clock, from seeded random
    packed-int32 frames made on the device; the temporal seed is threaded
    where cfg asks for it.  The step runs eagerly, never as the engine's
    CUDA graph (``engine/graph.py``): a replay only takes host time off
    the step, so on CUDA the rate measured is a lower bound of the rate
    the engine serves, and the preset it picks errs on the safe side."""
    device = resolve_device(device)
    step = make_interp_step(cfg, wire="i32", device=device)
    rng = np.random.default_rng(0)
    h, w = cfg.input_height, cfg.input_width
    fr = [torch.from_numpy(rng.integers(0, 2 ** 32, (h, w), dtype=np.uint32)
                           .view(np.int32)).to(device) for _ in range(2)]
    temporal = is_temporal(cfg)

    def one(mv):
        if temporal:
            *outs, mv = step(fr[0], fr[1], mv)
            return outs, mv
        return list(step(fr[0], fr[1])), None

    mv = (torch.zeros(mv_lattice_shape(cfg), dtype=torch.float32,
                      device=device) if temporal else None)
    outs, mv = one(mv)
    device_sync(outs[-1])
    t0 = time.perf_counter()
    for _ in range(max(1, n)):
        outs, mv = one(mv)
    device_sync(outs[-1])
    dt = time.perf_counter() - t0
    return max(1, n) / dt if dt > 0 else 0.0


def run_stream(cfg: EngineConfig, source: FrameSource, sink: FrameSink,
               precision: str = "fast", max_frames: Optional[int] = None,
               paced: bool = True, start_frame: int = 0,
               device: torch.device | str | None = None,
               model_params=None) -> StreamStats:
    return StreamingEngine(cfg, precision, device, model_params).run(
        source, sink, max_frames, paced, start_frame)
