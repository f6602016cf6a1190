"""The fast interpolating step replayed as one CUDA graph.

A stateless fast step (no ``--temporal-mv`` seed, no learned stream
cache) makes the same ~70 launches on the same shapes for every pair, and
on config 4 the host takes longer to queue them than the card takes to
run them.  :class:`GraphedStep` captures the step once into a CUDA graph
and replays it for every later pair: one launch in place of ~70.

The graph reads two static input buffers and writes static outputs.  Each
call copies the caller's prev and curr into the buffers on the current
stream (two device-to-device copies of the wire), replays, and returns
the graph's outputs, which the next replay overwrites: a caller that keeps
an output past the next call copies it first (the engine reads a host
sink's outputs back before the next pair and hands a device sink clones).
At identity size curr's output is the static curr buffer itself.
RAFT's flow (``pipeline.RaftFlow``) is such a graph inside an eager step,
with four inputs: prev's stream cache and curr.

The first call warms the step up on a side stream (which builds the kernel
library, the cached tap, band and candidate tables and the allocator's
blocks, so the capture queues no host-to-device copy), then captures it
and replays.  Inside ``kernels.common.plain_versions()`` and under
``utils.tracing.debug_checks`` (whose NaN guard synchronises, which a
capture refuses) the step runs eagerly, and nothing is captured or
replayed.  A call with other shapes, dtypes or device than the first's
raises: an engine's shapes are fixed by its configuration.

The kernel wrappers' ``launches`` counts (``kernels.common``) keep
counting what ran: a capture records the wrappers' launches and runs
none, so the counts it added are taken back and added again on every
replay.  The warm-up call runs the step, and counts as such.

Under a profiler session the copies and the replay are the
``tpufg.step.graph`` span; the step's own stage spans
(``tpufg.step.unpack``, ``.motion``, ``.warp``, ``.scale``) open only
where it runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpufg_torch.kernels.common import counted_wrappers, in_plain_versions
from tpufg_torch.utils.tracing import annotate, nan_guard_active


class CudaGraphs:
    """torch.cuda's graphs (a test passes another object with these two
    calls): ``warm`` runs ``fn`` once on a side stream, as PyTorch asks
    before a capture; ``capture`` records one call of ``fn`` into a new
    CUDA graph and returns (the graph's replay, ``fn``'s outputs)."""

    @staticmethod
    def warm(fn: Callable, device: torch.device) -> None:
        with torch.cuda.device(device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn()
            main.wait_stream(side)

    @staticmethod
    def capture(fn: Callable, device: torch.device):
        with torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph()
            # another thread's CUDA calls (a sink's, the preview's) do not
            # break this thread's capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = fn()
        return graph.replay, outs


class GraphedStep:
    """(prev, curr) -> the outputs of ``step`` (a stateless step of
    ``make_interp_step``; or any fixed inputs of a stage of one), from a
    replay of one captured call; see the module's docstring.  ``captures``
    and ``replays`` count the graphs captured and the calls run by
    replay."""

    def __init__(self, step: Callable, graphs=CudaGraphs):
        self.step, self.graphs = step, graphs
        self._inputs = None   # the static inputs the graph reads
        self._replay = None
        self._outs = None     # the graph's static outputs
        self._launched = ()   # (wrapper, launches) that one replay runs
        self.captures = self.replays = 0

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        if in_plain_versions() or nan_guard_active():
            return self.step(*inputs)
        if self._inputs is None:
            self._inputs = tuple(torch.empty_like(x) for x in inputs)
        with annotate("tpufg.step.graph"):
            for buf, x in zip(self._inputs, inputs, strict=True):
                if (x.shape, x.dtype, x.device) != (buf.shape, buf.dtype,
                                                    buf.device):
                    raise ValueError(
                        f"the step was captured for {tuple(buf.shape)} "
                        f"{buf.dtype} on {buf.device}, got "
                        f"{tuple(x.shape)} {x.dtype} on {x.device}")
                buf.copy_(x)
            if self._replay is None:
                self._capture()
            self._replay()
        for fn, n in self._launched:
            fn.launches += n
        self.replays += 1
        return self._outs

    def _capture(self) -> None:
        def run():
            return tuple(self.step(*self._inputs))

        device = self._inputs[0].device
        self.graphs.warm(run, device)
        wrappers = counted_wrappers()
        before = [fn.launches for fn in wrappers]
        self._replay, self._outs = self.graphs.capture(run, device)
        # the capture recorded these launches and ran none of them
        self._launched = tuple((fn, fn.launches - n)
                               for fn, n in zip(wrappers, before)
                               if fn.launches != n)
        for fn, n in self._launched:
            fn.launches -= n
        self.captures += 1
