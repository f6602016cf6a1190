#!/usr/bin/env python3
"""Smoke run of tpufg_torch on one CUDA card: build, check, drive, time.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Five paths are driven: config 4 (``synthetic:1920x1080`` -> 3840x2160,
pyramid motion), config 4q (the same with ``--quality on
--occlusion-blend``: sub-pel refine, MV bias and median, the per-pixel
OBMC warp, the occlusion blend and the MC fallback), config 3 (1920x1080
at identity size, exhaustive block matching at r = 16, the fractional
warp) and config 5 (3840x2160 at identity size, the learned head
``checkpoints/head64_v4.npz``) through the command line, and the kernel
API (``tpufg_torch.kernels``, the names ``tpufg.kernels`` exports)
composed into a 1080p -> 4K frame pair: unpack, per-pixel search, block
warp + blend, planar Lanczos.  The streaming engine's options run too:
``--fps-multiplier 4 --scene-cut 0.1 --temporal-mv`` on config 4, config 5
at ``--fps-multiplier 3``, config 3 with ``--scene-cut``, a 4K ``.y4m``
file whose C420 payloads the y4m egress kernel (csrc/yuv.cu) makes on the
card, and ``--overlay``.  The engine's warp (``warp_blend_matmul``,
an XLA op of the reference) runs on its CUDA kernels on configs 3, 4, 4q
and 5: the block walk, and on 4q the per-pixel warp (``warp_obmc``) and
the blend epilogue (``warp_epilogue``).  The exact precision path
(``--precision exact``, the GLSL-spec oracle) runs 1080p -> 4K on its
three kernels: the per-pixel search with the exact box
(csrc/motion_tiled.cu), the shader's warp (csrc/oracle_warp.cu) and its
Lanczos scale with the UNORM8 store (csrc/oracle_scale.cu); ``--trace`` and
``--debug-checks`` run on config 4, and ``python -m tpufg_torch.validate``
checks the bf16 precision gate at 1080p -> 4K.  RIFE's own network
(config 6, ``tpufg_torch/models/ifnet.py``) runs its step at 4K on the
benchmark's configuration ``fgbench/configs/c6-4k-rife-ifnet.json``
(:func:`config6_phase`), and RAFT's optical flow (config 7,
``tpufg_torch/models/raft.py``) its 1080p -> 4K step on
``fgbench/configs/c7-1080p-4k-raft.json`` (:func:`config7_phase`).
Phases (each one checks its results and raises on a failure, so the exit
code is non-zero and no result line is printed):

1. the card (nvidia-smi name and power limit, torch and CUDA versions) and
   the nvcc build of tpufg_torch/csrc/*.cu, with its time and ptxas report,
   and the registers, spills and blocks per SM of the kernels whose
   occupancy the launch plans or the design depends on (the sites search,
   both Lanczos kernels, config 4q's two warp kernels, the y4m egress
   kernel, the exact path's scale and warp);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the paths give it (unpack, box2, both motion searches, the
   planar Lanczos, the block warp in its three modes, the engine's warp
   at each path's shape and mode, and config 4q's per-pixel warp (pair,
   blend, single, and the pair with the fallback's cell means), blend
   epilogue (occlusion and fallback; the cell means made or given) and engine
   warp with the options (per-pixel, block 16, block 8) bitwise; packed
   Lanczos no differing
   byte; the two convs within the relative bounds below, the chain with 17
   and with 13 input channels, the stride-2 conv also with 8), the sites
   search also on a narrower frame with C = 3 and at r = 4, the packed
   Lanczos also at two downscales (the tile walk and the direct stencil
   its plan picks) and at a = 2, the planar Lanczos also with 17 channels
   and at two downscales (the tile walk with one channel a block, and the
   direct stencil); the y4m egress kernel bitwise at 4K C420 and C444, at
   1080p C420 and on every code at both clips, and equal to the host
   egress of io/sinks.py; the tiled search with the exact box at the
   exact path's [4, 1080, 1920] b8 r16; the exact path's scale bitwise at
   1080p -> 4K, 1440p -> 1080p and identity and on the UNORM8 store's .5
   ties and clamps, its warp bitwise at 1080p with a per-pixel MV field
   past every edge at t = 0.25 and 0.5 and as a crossfade;
3. each path (config 4 over 16 frames, config 4q over 8, config 3 over
   16, config 3 at ``--block-size 16`` over 4, config 5 over 8, the kernel
   API over 2 pairs), each with the kernels' launch counts read from a
   zeroed start: every kernel of the path must have run on every frame
   (pair; where the engine replays a CUDA graph of the step, a replay
   counts the launches it runs, and the warm-up before the capture runs
   the step once more, ``step_calls``), and no other (the engine's block
   warp: 2 per pair on config 4,
   3 on 4q (the refine and two sub-pel probes; its per-pixel warp 1, with
   the fallback's cell means, and epilogue 1), 1 on config 3, 4 on config
   5, so every warp of the kernel
   path launched its kernel, and its plain version was called on the card
   0 times); ``--quality auto`` (its step-rate log line); the
   kernel API pair's pan velocity in its MV field, its
   in-between frame against the exactly shifted source, and its 4K bytes
   against the packed Lanczos kernel's; the engine's options (config 4
   with x4, the scene cut and the temporal seed over 16 frames, 61 out;
   config 5 at x3; config 3 with the scene cut; a 4K C420 y4m file through
   the y4m kernel, equal byte for byte to the same run on the host
   egress; the overlay), each with its launch counts; ``--precision
   exact`` 1080p -> 4K (the tiled search once a pair, the warp once and
   the scale twice a pair, the first frame's scale, their plain versions
   0 times on the card) and with ``--no-interpolation``; ``--trace DIR`` on
   config 4 (the trace file, its ``tpufg.step`` spans' device durations);
   ``--debug-checks`` on config 4, and a NaN planted in a kernel's input
   raising FloatingPointError at the launch;
4. the kernel path against the plain path (the same calls inside
   ``kernels.common.plain_versions()``) on the same three frames of an
   even pan (MV fields bitwise, output bytes within 1 code), the pan's
   velocity in the MV field, and the in-between frame against the exactly
   shifted source, for configs 4 and 3; for config 4q the same paths
   compared, and on a (3, 1) px/frame pan its in-between frame closer in
   PSNR than config 4's to the source sampled at the half offset; for
   config 5 the head's output and the bytes within the bounds below, and
   the stream cache bitwise; the temporal seed over a 1080p -> 4K pan that
   accelerates to 40 px/frame (MV fields bitwise between the paths with
   each path's seed threaded, the seeded step on the pan from the 4th pair
   on, the unseeded pyramid off it), a scene cut at x4 (the nearer
   source's scaled frame byte for byte, the next seed zeros), config 4 at
   x4 (within 1 code) and the synchronisations of the temporal x4 cut
   y4m step against config 4's (torch.cuda.set_sync_debug_mode); the exact
   step's kernel path against its plain path at 270x480 -> 540x960 b8 r16
   over 3 pan pairs (bytes bitwise, the MV field bitwise to the oracle's
   search), the pan's known answer
   (the exact MV is the pan, the midpoint the half-shifted source), and
   ``python -m tpufg_torch.validate`` at 1080p -> 4K over 2 pairs
   (precision SSIM >= 0.999); config 6 at 3840x2160 on 3 pairs of the
   benchmark's bank: the kernel step bitwise to the plain step, its six
   kernels' launches a pair, the benchmark's check on its outputs within
   the limit, the reference with its conv sums reordered within it, the
   fp8 control and the planted flow and mask faults past it, and the
   Contextnet faults' readings (:func:`config6_phase`); config 7 at
   1920x1080 -> 3840x2160 on 3 pairs of its bank: RAFT's five kernels
   bitwise to their plain versions on the arguments the path gives them,
   and timed, the seeded flow's median |F|, the kernel step (the flow as
   one CUDA graph replay) bitwise to the plain step, the kernels' launches
   a pair, the benchmark's check within the limit, the fp8 control and
   the planted faults past it (:func:`config7_phase`);
5. timing with CUDA events: each step (ms per pair p50/p99, output fps)
   beside the host's time to enqueue a pair (wall clock around step calls
   that are not synchronised), config 4 also at x4, with the temporal seed
   and with the y4m egress, the exact step 1080p -> 4K (p50 / p99 over
   10 pairs after 2, and its stages), and config 5a (the pyramid at 4K
   identity size), each of these also profiled (device activities, busy time and
   idle share of one profiled window; a marker kernel between calls shows
   whether a profiler session kept every record), the synchronised
   stages of configs 4, 4q, 3 and 5, and each kernel beside its plain
   version and, where one PyTorch call computes the same function, that
   call (``F.avg_pool2d`` for box2, cuDNN's ``F.conv2d`` with TF32 off for
   the stride-2 conv, ``F.grid_sample`` on a prebuilt per-pixel grid for the
   single-mode warps, the grid's making not counted); the convs are timed
   with their weights already
   packed (the wrappers pack once per set of weight tensors, which a
   profile of the stride-2 conv's calls shows: one kernel a call; a profile
   of ``warp_obmc``'s shows the same, its offsets made in the kernel); every
   kernel also as 50 calls in a CUDA graph that cycles through copies of
   its operands past twice the L2, the device's time alone, which the
   summary rows carry as ``device_ms`` beside the call's ``ms`` (a call's
   host cost exceeds the kernel's time at the smaller shapes).

The last three lines of standard output are the kernel summary (JSON: per
kernel its launches on its path, max |kernel - plain|, kernel, plain and
library ms, its device ms, and its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over the H100's peak for their
type; the tiled search has a second row at the exact path's shape, and
RAFT's five kernels rows timed in phase 4), the
card's ``name, power.limit`` and ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 2 before any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

IN_W, IN_H, OUT_W, OUT_H = 1920, 1080, 3840, 2160
N_FRAMES = 16             # config-4 CLI run
Q4_FRAMES = 8             # config-4q CLI run (and 3 with --quality auto)
# config 4q's settings beyond config 4's: tools/bench_matrix.py's row 4q,
# the quality preset (tpufg_torch.config.apply_quality_preset) and
# --occlusion-blend
Q4 = dict(mv_grid=1, subpel=True, mv_bias=0.1, mv_filter=True,
          mc_fallback=True, occlusion_blend=True)
C3_FRAMES = 16            # config-3 CLI run
C3_B16_FRAMES = 4         # config 3 at --block-size 16 (the tiled search)
C5_FRAMES = 8             # config-5 CLI run (3840x2160, learned head)
RADIUS = 16               # config 3's search radius
T4_FRAMES = 16            # config 4 with --fps-multiplier 4 --scene-cut
#                           0.1 --temporal-mv: 4 * 15 + 1 = 61 frames out
OPT_FRAMES = 4            # config 5 at x3, config 3 with the scene cut, y4m
CUT = 0.1                 # --scene-cut
# the temporal known answer: a horizontal pan over one texture that
# accelerates 10 -> 40 px/frame over three pairs, then holds 40 px/frame
# (twice the unseeded pyramid's ~20 px reach) for ten more.  tpufg does not
# lock on 40 px/frame from a zero seed (its CPU run at 128 x 384: hit rate
# 0 on all 12 pairs); on this pan its seeded hit rate is 1.0 on every pair
# and its unseeded one 0.0 from 30 px/frame (tests/test_torch_engine_
# options.py, which holds the port's MV fields bitwise to tpufg's there)
TRACK_VELOCITY = (10, 20, 30) + (40,) * 10
HIT_TOL = 2.0             # px: the pyramid's finest searched level is 1/2
SEEDED_HIT_MIN = 0.9      # from the 4th pair on
UNSEEDED_HIT_MAX = 0.1    # at 40 px/frame
API_PAIRS = 2             # kernel API path: 1080p pairs -> 4K
API_H = 1088              # 1080 rows edge-padded to the 16-px blocks
EXACT_FRAMES = 4          # --precision exact CLI runs, 1080p -> 4K
TRACE_FRAMES = 20         # config 4 with --trace
DEBUG_FRAMES = 4          # config 4 with --debug-checks
# the exact step's kernel path against its plain path (whose search is
# ~80k torch calls a pair): a quarter of 1080p, 3 pairs of the (4, 2) pan
EX_H, EX_W, EX_PAIRS = 270, 480, 3
EXACT_HIT_MIN = 0.99      # the pan's known answer, on the interior
# conv kernels vs their plain versions, relative to max |plain|: the
# stride-2 conv rounds its operands as the plain conv does and only sums
# in another order (f32: 2e-5, tpufg's own f32 bound, used for bf16 too);
# the chain's intermediates round to bf16, where a sum next to a rounding
# boundary can round the other way: tpufg's own bf16 bound 3e-2
S2_MAX_REL = 2e-5
CHAIN_MAX_REL = {"f32": 2e-5, "bf16": 3e-2}
# config 5, kernel path vs plain path.  The head's output is the stage-2
# chain's plus the upsampled coarse output, so the chain's bf16 bound
# holds it: 3e-2 of max |value| (tests/test_torch_rife.py holds the port
# to 5e-3 of tpufg's on 80 x 112 frames; a 4K frame has ~600x the
# outputs, and the largest bf16 rounding flip grows with the count).  The
# bytes: within 1 code on all but 1e-3 of them, the bound
# tests/test_torch_learned.py holds the port's step to against tpufg's
C5_TRUNK_MAX_REL = CHAIN_MAX_REL["bf16"]
C5_BYTES_MAX_FRAC = 1e-3
# config 6: RIFE's IFNet (tpufg_torch/models/ifnet.py) at 3840x2160 on the
# benchmark's configuration and bank (its seed below), kernel path vs
# plain path over C6_PAIRS pairs with the stream cache.  Per pair, each of
# the model's six kernels launches: bias + PReLU 30 times in the three
# IFBlocks, 8 in curr's Contextnet and 12 in the U-Net; the frames' warp
# after each block; the context warp 4 levels x 2 frames; the conv input
# pack for each block, the Contextnet and the U-Net; the merge once; the
# flow and mask accumulation once a block.  The frame unpack: prev and curr
C6_CONFIG = "fgbench/configs/c6-4k-rife-ifnet.json"
C6_PAIRS = 3
C6_SEED = 2 ** 31 + 1723
C6_LAUNCHES = {"frames_to_planar": 2, "bias_prelu": 50, "warp_frames": 3,
               "warp_features_into": 8, "pack_nhwc": 5, "ifnet_merge": 1,
               "ifnet_accum": 3}
# config 7: RAFT's optical flow (tpufg_torch/models/raft.py) at 1080p ->
# 4K on the benchmark's configuration and bank (its seed below), kernel
# path vs plain path over C7_PAIRS pairs with the stream cache.  Per pair,
# inside the flow's CUDA graph (which the warm-up before the capture runs
# once more): the lookup once an update, the pyramid's pooling once, the
# upsampling once, each GRU pass twice an update, the bias adds (32 in
# curr's encoders, 7 an update, 2 in the mask) and the pack of curr;
# outside it the unpack of prev and curr, the warp of both frames and the
# Lanczos of the midpoint and of curr
C7_CONFIG = "fgbench/configs/c7-1080p-4k-raft.json"
C7_PAIRS = 3
C7_SEED = 2 ** 31 + 1777
C7_GRAPHED = {"corr_lookup": 12, "corr_pool": 1, "convex_upsample": 1,
              "gru_gates": 24, "gru_update": 24, "bias_prelu": 118,
              "pack_nhwc": 1}
C7_EAGER = {"frames_to_planar": 2, "warp_frames": 1,
            "lanczos_scale_packed": 2}
# the H100 SXM's published peaks (NVIDIA data sheet, dense): device memory
# bytes/s, and operations/s in f32 on CUDA cores and bf16 on tensor cores
HBM_BYTES_PER_S = 3.35e12
# f64 (the exact path's fused multiply-adds, rounded as XLA's): 34 TFLOP/s,
# the same data sheet's FP64 rate outside the tensor cores
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "f64": 34e12}
# its L2 cache: device times (graph_ms) cycle through operand sets that
# together exceed twice this, so no call finds its operands left there
L2_BYTES = 50 * 2 ** 20


# the block warp's checked and timed modes, at [4, API_H, IN_W] b16 r16
BLOCK_WARP_MODES = {"t=0.5": dict(factor=0.5), "t=0.25": dict(factor=0.25),
                    "single": dict(single=True)}
# the engine warp's checked and timed cases, each path's shape and mode:
# label -> (shape, block, radius, whole-pixel MVs, kwargs, crop); dtype
# "bf16" or "f32" (tools/torch_kernel_variants.py times these too)
ENGINE_WARPS = {
    "config 4 blend": ((4, 1088, 1920), 16, 16, True,
                       dict(factor=0.5, dtype="bf16", integer_offsets=True,
                            u8_exact=True), (1080, 1920)),
    "config 4 refine": ((4, 544, 960), 16, 10, True,
                        dict(single=True, integer_offsets=True), None),
    "config 3 blend": ((4, 1088, 1920), 16, 16, False,
                       dict(factor=0.5, dtype="bf16", u8_exact=True),
                       (1080, 1920)),
    "blend t=0.25": ((4, 1088, 1920), 16, 16, False,
                     dict(factor=0.25, dtype="bf16", u8_exact=True),
                     (1080, 1920)),
    "config 5 coarse": ((4, 544, 960), 8, 4, True,
                        dict(single=True, dtype="bf16",
                             integer_offsets=True), None),
    "config 5 tail": ((4, 2160, 3840), 16, 8, False,
                      dict(single=True, dtype="bf16"), None),
}


# lanczos_scale_fast's checked and timed shapes: the kernel API path's, the
# same in bf16, a 3-channel stack, the learned head's 17 channels (four
# groups of 4 and one of 1), and two downscales: by 4/3 the tiles are still
# walked (one channel a block), by 4 the plan picks the direct stencil
PLANAR_SHAPES = (((4, 1080, 1920), (OUT_H, OUT_W), "f32"),
                 ((4, 1080, 1920), (OUT_H, OUT_W), "bf16"),
                 ((3, 720, 1280), (1440, 2560), "f32"),
                 ((17, 540, 960), (1080, 1920), "f32"),
                 ((4, 1440, 2560), (1080, 1920), "f32"),
                 ((4, 2160, 3840), (540, 960), "f32"))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def in_scope(scope, fn, *args):
    """``fn(*args)`` inside the context manager ``scope()``."""
    with scope():
        return fn(*args)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a, b) -> bool:
    """Bitwise equality of two f32 tensors (distinguishes -0 and NaNs)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def byte_diff(a, b):
    """(max |delta|, count of differing bytes, byte count) of two wires."""
    import torch
    x = a.contiguous().view(torch.uint8).to(torch.int16)
    y = b.contiguous().view(torch.uint8).to(torch.int16)
    d = (x - y).abs()
    return int(d.max()), int((d > 0).sum()), d.numel()


def time_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """Mean device ms per call over ``n`` back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, ops, kind: str = "f32") -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` (each input read once, each output written once)
    and to do ``ops`` operations of type ``kind`` (or ``ops`` a dict of
    counts by type, each at its own peak), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if not isinstance(ops, dict):
        ops = {kind: ops}
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lanczos_ops(c: int, ih: int, oh: int, ow: int, taps: int) -> int:
    """Operations of the separable resample (the plain version's form):
    a taps-long multiply-add row at every (input row, output column), then
    one at every output pixel, per channel."""
    return c * (ih * ow + oh * ow) * (2 * taps - 1)


def warp_mvs(rng, shape, g: int, r: int, whole: bool,
             single: bool) -> np.ndarray:
    """f32 [2, H/g, W/g] MVs for a warp of [C, H, W] frames, up to 4 px
    past the clip at ``r``: whole pixels (even ones in a blend, which moves
    each side by half) or continuous, so that the fractions round to bf16
    as the learned tail's flows do."""
    n = (2, shape[1] // g, shape[2] // g)
    if whole:
        return (rng.integers(-r - 4, r + 5, n)
                * (1 if single else 2)).astype(np.float32)
    return rng.uniform(-r - 4, r + 4, n).astype(np.float32)


def operand_sets(tensors, call_bytes: int) -> list:
    """``tensors`` and enough copies of them that calls moving
    ``call_bytes`` each, one set after another, move more than twice the
    L2 before a set comes round again."""
    k = max(1, -(-2 * L2_BYTES // int(call_bytes)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(k - 1)]


def graph_ms(fn, sets, n: int = 50, warmup: int = 3) -> float:
    """Device ms per call: ``n`` calls ``fn(*set)``, cycling through
    ``sets`` (:func:`operand_sets`), captured in one CUDA graph and
    replayed between two events, so the host's cost per call (Python, the
    wrapper's checks, the ctypes call) is left out.  Each call's result is
    held until its set comes round again, so no call writes over the
    buffer the call before it wrote."""
    import torch
    for i in range(max(warmup, len(sets))):
        fn(*sets[i % len(sets)])
    held = [None] * len(sets)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            held[i % len(sets)] = fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_pair(kernel_fn, plain_fn, n: int = 50,
              n_plain: int = 50) -> tuple[float, float]:
    """Kernel and plain ms, measured in turns (k, p, p, k) and averaged."""
    k1 = time_ms(kernel_fn, n)
    p1 = time_ms(plain_fn, n_plain, warmup=1)
    p2 = time_ms(plain_fn, n_plain, warmup=1)
    k2 = time_ms(kernel_fn, n)
    return (k1 + k2) / 2, (p1 + p2) / 2


def drive(argv, kernels) -> tuple:
    """Run the CLI with every kernel's launch count set to 0 just before;
    return (exit code, stats, launch counts read just after)."""
    import torch
    from tpufg_torch import cli
    for fn in kernels:
        fn.launches = 0
    rc, stats = cli.run(argv)
    torch.cuda.synchronize()
    return rc, stats, {fn.__name__: fn.launches for fn in kernels}


def step_calls(stats) -> int:
    """The runs of a CLI run's interpolating step on the card: one a pair,
    eager or replayed from its CUDA graph, and the warm-up before each
    capture (the capture runs nothing, ``engine/graph.py``)."""
    return stats.frames_in - 1 + stats.graph_captures


def step_times(step, frames, n: int = 50, warmup: int = 10,
               outs_per_pair: int = 2):
    """(p50, p99 ms per pair, steady output fps) of ``step`` over
    ``n`` pairs after ``warmup``, CUDA events around each call;
    ``outs_per_pair`` frames leave each pair (k at ``--fps-multiplier``
    k)."""
    import torch
    ev = []
    for j in range(warmup + n):
        prev, curr = frames[j % 2], frames[j % 2 + 1]
        if j < warmup:
            step(prev, curr)
            continue
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(prev, curr)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    per = np.array([a.elapsed_time(b) for a, b in ev])
    total = ev[0][0].elapsed_time(ev[-1][1])
    return (float(np.percentile(per, 50)), float(np.percentile(per, 99)),
            outs_per_pair * len(ev) / (total / 1e3))


MARKER = "spin_kernel"     # torch.cuda._sleep's kernel, the profile marker


def device_records(fn, calls: int, attempts: int = 3) -> list:
    """The device records (kernels, copies, fills) that ``torch.profiler``
    takes of ``calls`` calls ``fn(0) .. fn(calls - 1)``, as (name, start
    us, end us), in one session that records the CUDA activity alone.  A
    marker kernel (``torch.cuda._sleep``, a few hundred ns) runs before
    each call and after the last, and its records are left out.  The
    profiler keeps only the records inside its session's window on the
    host clock, and on the H100 it has lost records (3 of 5 kernels, or 5
    of 5) at the edges of a session, so the session waits 50 ms on the
    host after it starts and before it stops; one whose markers are still
    not all there is run again, at most ``attempts`` times, and a session
    with fewer markers every time fails the run.  [] when no session
    recorded anything: the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    last = None                  # (markers, records, edges) of a session
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for j in range(calls):
                torch.cuda._sleep(256)
                fn(j)
            torch.cuda._sleep(256)
            torch.cuda.synchronize()
            time.sleep(0.05)
        recs = sorted(((e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda r: r[1])
        marks = sum(MARKER in n for n, _, _ in recs)
        if marks == calls + 1:
            return [r for r in recs if MARKER not in r[0]]
        edges = (recs and MARKER in recs[0][0], recs and MARKER in recs[-1][0])
        print(f"profiler session {attempt + 1} dropped device records: "
              f"{marks} of its {calls + 1} markers, {len(recs)} records, "
              f"first and last a marker: {edges}")
        if recs:
            last = (marks, len(recs), edges)
    check(last is None, f"the profiler dropped device records in "
          f"{attempts} sessions (markers, records, first and last a marker, "
          f"of the last: {last})")
    return []


def device_kernels(fn, calls: int = 5) -> int:
    """Device kernels ``torch.profiler`` records over ``calls`` calls of
    ``fn`` (0: the profiler saw no device activity)."""
    return len(device_records(lambda j: fn(), calls))


def device_profile(step, frames, pairs: int = 10) -> tuple[int, float, float]:
    """(device activities, device busy ms, window ms) of ``step`` over
    ``pairs`` pairs under ``torch.profiler``: kernels, copies and fills;
    busy time is the union of their intervals on the device, the window
    runs from the first one's start to the last one's end, so both come
    from the same records (the markers between pairs are left out of both
    counts and busy time).  No profiler schedule: its step records would
    show as device activities spanning each pair."""
    import torch
    step(frames[0], frames[1])
    torch.cuda.synchronize()
    spans = sorted((a, b) for _, a, b in device_records(
        lambda j: step(frames[j % 2], frames[j % 2 + 1]), pairs))
    if not spans:
        return 0, 0.0, 0.0
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(spans), busy_us / 1e3, (end - spans[0][0]) / 1e3


def host_enqueue_ms(step, frames, rounds: int = 10, pairs: int = 2) -> float:
    """Median host ms to enqueue one pair: wall clock around ``pairs``
    step calls that start on an idle device and are not synchronised (few
    enough launches that the launch queue never fills, so the host is not
    held back by the device)."""
    import torch
    per = []
    for j in range(rounds + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(pairs):
            step(frames[i % 2], frames[i % 2 + 1])
        per.append((time.perf_counter() - t0) / pairs * 1e3)
    torch.cuda.synchronize()
    return float(np.median(per[2:]))


def pan_frames(n: int, velocity=(4.0, 2.0), w: int = IN_W, h: int = IN_H):
    """n synthetic pan frames as packed int32 [h, w] numpy arrays."""
    from tpufg_torch.io.sources import SyntheticSource
    src = SyntheticSource(w, h, n_frames=n, velocity=velocity)
    return [f.view(np.int32).reshape(h, w) for f in src]


def track_frames(h: int, w: int, velocity) -> list:
    """Packed int32 [h, w] numpy frames of a horizontal pan with per-pair
    velocities ``velocity`` over one synthetic texture (no wrap-around)."""
    from tpufg_torch.io.sources import SyntheticSource
    offs = np.concatenate([[0], np.cumsum(velocity)]).astype(int)
    big = next(iter(SyntheticSource(w + int(offs[-1]) + 8, h, n_frames=1)))
    return [np.ascontiguousarray(big[:, o:o + w]).view(np.int32).reshape(h, w)
            for o in offs]


def track_hit(mv, v: float) -> float:
    """Share of the MV lattice's interior (one cell in from each edge, four
    from the right, where the pan brings new content in) within HIT_TOL px
    of the pan's backward flow (v, 0)."""
    m = mv[:, 1:-1, 1:-4]
    return float((((m[0] - v).abs() <= HIT_TOL)
                  & (m[1].abs() <= HIT_TOL)).float().mean())


class Seeded:
    """A temporal step as a two-argument step: threads the MV seed (zeros
    of ``shape`` to start) between calls, on the device."""

    def __init__(self, step, shape, device):
        import torch
        self.step = step
        self.mv = torch.zeros(shape, dtype=torch.float32, device=device)

    def __call__(self, prev, curr):
        *outs, self.mv = self.step(prev, curr, self.mv)
        return outs


def rel_err(k, p) -> tuple[float, float]:
    """(max |k - p| / max |p|, 99.9th percentile of |k - p|)."""
    import torch
    d = (k - p).abs().flatten()
    sample = d[::-(-d.numel() // (1 << 24))]   # quantile takes <= 2^24
    return (float(d.max() / p.abs().max()),
            float(torch.quantile(sample, 0.999)))


def pan_mv_hit(mv) -> float:
    """Share of the interior MV lattice equal to the pan's (4, 2) (the
    backward flow of a (4, 2) px/frame pan: curr[q] = prev[q + (4, 2)])."""
    inner = mv[:, 2:-3, 2:-2]
    return float(((inner[0] == 4) & (inner[1] == 2)).float().mean())


def midpoint_match(mid, prev_wire, as_bytes: bool) -> float:
    """Share of the interior where the in-between frame of the (4, 2) pan
    equals prev shifted by (2, 1).  The integer-offset warp (config 4) moves
    source values exactly, so its floats are compared; the fractional warp
    (config 3) moves bf16-rounded centred values, which round back to the
    source's codes, so its UNORM8 bytes are compared."""
    from tpufg_torch.kernels.convert import (frames_to_planar_plain,
                                             planar_to_i32)
    inner = (slice(32, IN_H - 32), slice(32, IN_W - 32))
    if as_bytes:
        got, ref = planar_to_i32(mid)[:-1, :-2], prev_wire[1:, 2:]
    else:
        got = mid[:, :-1, :-2]
        ref = frames_to_planar_plain(prev_wire)[:, 1:, 2:]
        inner = (slice(None),) + inner
    return float((got[inner] == ref[inner]).float().mean())


def _context_warp_fault(channels, mult: float):
    def wrap(warp):
        def call(out, offset, feats, flow):
            hit = channels is None or feats.shape[1] == channels
            return warp(out, offset, feats, flow * mult if hit else flow)
        return call
    return wrap


def _unscaled_flow_fault(block):
    def call(p, name, frames, warped, mask, flow, scale):
        if flow is not None:
            flow = flow * scale
        return block(p, name, frames, warped, mask, flow, scale)
    return call


def _no_mask_delta_fault(block):
    def call(p, name, frames, warped, mask, flow, scale):
        t = block(p, name, frames, warped, mask, flow, scale)
        if name == "block2":
            t[:, 4:5].zero_()
        return t
    return call


# config 6's planted faults: (name, the attribute of models/ifnet.py
# replaced, its replacement made from it, whether the benchmark's check
# refuses it).  Faults in the flow and mask read 0.33-0.37 at 4K, past the
# limit; the Contextnet's warps reach the output only through the U-Net's
# residual, and with the seeded weights even leaving them out reads 0.027
# against the program's 0.022: within the limit, a blind spot of the check
# that this phase measures on every run (PERF.md)
C6_FAULTS = (
    ("IFBlocks 1-2 fed the flow not divided by their scale", "_ifblock",
     _unscaled_flow_fault, True),
    ("IFBlock 2's mask delta dropped", "_ifblock", _no_mask_delta_fault,
     True),
    ("context level 4 warped by twice its flow", "warp_features_into",
     _context_warp_fault(128, 2.0), False),
    ("context not warped", "warp_features_into",
     _context_warp_fault(None, 0.0), False),
)


def _split_sums(conv, transposed: bool):
    """``conv`` (F.conv2d or F.conv_transpose2d) with its input channels
    summed in two halves, one call each: the same sum in another order."""
    def call(x, w, b=None, *args):
        h = x.shape[1] // 2
        if h == 0:
            return conv(x, w, b, *args)
        wa, wb = (w[:h], w[h:]) if transposed else (w[:, :h], w[:, h:])
        return conv(x[:, :h], wa, b, *args) + conv(x[:, h:], wb, None, *args)
    return call


def config6_phase(tag: str = "") -> dict:
    """Phase 4's config 6: RIFE's IFNet, the benchmark's configuration
    (3840x2160, learned_scale 0.5, the recipe's weights) on C6_PAIRS pairs
    of its bank, with the stream cache.  The kernel step against the plain
    step (in ``plain_versions()``, the kernels' plain torch versions): every
    output and the last cache bitwise; the kernels' launches per pair
    (C6_LAUNCHES) read from a zeroed start, and none on the plain run.
    Then the benchmark's check (``fgbench.check.compare`` against
    ``fgbench/reference/rife_ifnet.py`` in bf16) on the kernel path's
    outputs within the configuration's limit, and three readings of that
    check beside it: the reference with every conv's input channels summed
    in two halves (the same arithmetic in another order: within the
    limit), the reference in fp8 (the control: past it), and the kernel
    path with each planted fault of C6_FAULTS (each moves the output; those
    marked caught read past the limit)."""
    import torch
    import torch.nn.functional as F

    from fgbench import check as fg_check
    from fgbench import load as fg_load
    from fgbench.reference import rife_ifnet
    from tpufg_torch.config import EngineConfig
    from tpufg_torch.engine.pipeline import make_interp_step, make_q_init
    from tpufg_torch.kernels.accum import ifnet_accum
    from tpufg_torch.kernels.common import plain_versions
    from tpufg_torch.kernels.convert import frames_to_planar
    from tpufg_torch.kernels.merge import ifnet_merge
    from tpufg_torch.kernels.pack import pack_nhwc
    from tpufg_torch.kernels.prelu import bias_prelu
    from tpufg_torch.kernels.warp_grid import warp_features_into, warp_frames
    from tpufg_torch.models import ifnet, rife

    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    conf = json.load(open(os.path.join(root, C6_CONFIG)))
    cfg = EngineConfig(**conf["engine"]).validate()
    h, w = cfg.input_height, cfg.input_width
    params = rife.load_params(os.path.join(root, conf["checkpoint"]))
    bank = fg_load.make_bank(C6_SEED, h, w, C6_PAIRS + 1, 5, dev)
    wires = [torch.from_numpy(b.view(np.int32).reshape(h, w)).to(dev)
             for b in bank]
    kernels = (frames_to_planar, bias_prelu, warp_frames, warp_features_into,
               pack_nhwc, ifnet_merge, ifnet_accum)
    limit = conf["limits"]["bad_byte_share"]

    def run(scope=contextlib.nullcontext):
        step = make_interp_step(cfg, wire="i32", device=dev,
                                model_params=params, q_feed=True)
        outs = []
        with scope():
            q = make_q_init(cfg, params, dev)(wires[0])
            for fn in kernels:
                fn.launches = 0
            for i in range(C6_PAIRS):
                *o, q = step(wires[i], wires[i + 1], q)
                outs.append(o)
        torch.cuda.synchronize()
        return outs, q, {fn.__name__: fn.launches for fn in kernels}

    def kept(outs):
        return {i + 1: [o.cpu().numpy().view(np.uint8).reshape(h, w, 4)
                        for o in pair] for i, pair in enumerate(outs)}

    def compare(frames, prec="bf16"):
        ref = rife_ifnet.make(conf, prec, dev, root)
        with torch.no_grad():
            return fg_check.compare(frames, "rgba", bank, ref, dev)

    with torch.no_grad():
        outs_k, q_k, launches = run()
        outs_p, q_p, launches_p = run(plain_versions)
    print(f"phase 4: config 6 launches over {C6_PAIRS} pairs: {launches}; "
          f"plain run {launches_p}")
    check(launches == {k: v * C6_PAIRS for k, v in C6_LAUNCHES.items()},
          "config 6: kernel launches a pair")
    check(not any(launches_p.values()), "config 6: the plain path launched "
          "a kernel")
    for i, (ok, op) in enumerate(zip(outs_k, outs_p)):
        mx, nd, nb = byte_diff(ok[0], op[0])
        print(f"phase 4: config 6 pair {i}: midpoint kernel vs plain max "
              f"|d| {mx}, {nd} of {nb} bytes differ")
        check(nd == 0, f"config 6 pair {i}: midpoint kernel vs plain")
        check(torch.equal(ok[1], wires[i + 1]) and torch.equal(op[1],
                                                               wires[i + 1]),
              f"config 6 pair {i}: curr passes through")
    check(all(torch.equal(a, b) for a, b in zip(q_k, q_p)),
          "config 6: stream cache kernel vs plain")
    print("phase 4: config 6 kernel path bitwise to the plain path "
          "(midpoints, curr, the last stream cache)")

    frames_k = kept(outs_k)
    del outs_p
    reading = {"program": compare(frames_k), "fp8": compare(frames_k, "fp8")}
    # the reference with its sums in another order, as its own outputs
    ref = rife_ifnet.make(conf, "bf16", dev, root)
    orig = (F.conv2d, F.conv_transpose2d)
    F.conv2d, F.conv_transpose2d = (_split_sums(orig[0], False),
                                    _split_sums(orig[1], True))
    try:
        with torch.no_grad():
            reordered = {i: [o.cpu().numpy() for o in ref.pair(
                wires[i - 1], wires[i])] for i in frames_k}
    finally:
        F.conv2d, F.conv_transpose2d = orig
    reading["reordered reference"] = compare(reordered)
    moved = {}
    for name, attr, wrap, _ in C6_FAULTS:
        orig_fn = getattr(ifnet, attr)
        setattr(ifnet, attr, wrap(orig_fn))
        try:
            with torch.no_grad():
                outs_f, _, _ = run()
        finally:
            setattr(ifnet, attr, orig_fn)
        # the fault's own reach: the midpoint bytes it changed, and those
        # it moved more than a code, from the program's
        gaps = [(a[0].view(torch.uint8).to(torch.int16)
                 - b[0].view(torch.uint8).to(torch.int16)).abs()
                for a, b in zip(outs_f, outs_k)]
        n = sum(g.numel() for g in gaps)
        moved[name] = (sum(int((g > 0).sum()) for g in gaps) / n,
                       sum(int((g > 1).sum()) for g in gaps) / n)
        reading[name] = compare(kept(outs_f))
        del outs_f, gaps
    for name, r in reading.items():
        print(f"phase 4: config 6 check, {name}: bad_byte_share "
              f"{r['bad_byte_share']:.6f} (limit {limit}), max_code_gap "
              f"{r['max_code_gap']}, bytes {r['bytes_compared']}"
              + ("; midpoint bytes changed from the program's {:.6f}, by "
                 "more than a code {:.6f}".format(*moved[name])
                 if name in moved else "") + f" {tag}")
    check(reading["program"]["missing_frames"] == 0,
          "config 6: check frames missing")
    check(reading["program"]["bad_byte_share"] <= limit,
          "config 6: the kernel path fails the benchmark's check")
    check(reading["reordered reference"]["bad_byte_share"] <= limit,
          "config 6: the reordered reference fails the benchmark's check")
    check(reading["fp8"]["bad_byte_share"] > limit,
          "config 6: the fp8 control passes the benchmark's check")
    for name, _, _, caught in C6_FAULTS:
        check(moved[name][0] > 0, f"config 6: {name}: the output did not "
              "move")
        if caught:
            check(reading[name]["bad_byte_share"] > limit,
                  f"config 6: {name}: passes the benchmark's check")
    return reading


def _iters_fault(n):
    return n - 1


def _z_closed_fault(update):
    def call(zr, *args):
        zr = zr.clone()
        zr[:, :128] = -1e4      # sigmoid(z) = 0: h is never updated
        return update(zr, *args)
    return call


def _level_shift_fault(lookup):
    def call(pyramid, coords):
        out = lookup(pyramid, coords)
        moved = coords.clone()
        moved[:, 0] += 2.0      # one pixel of level 1
        out[:, 81:162] = lookup(pyramid, moved)[:, 81:162]
        return out
    return call


def _no_softmax_fault(upsample):
    def call(flow, mask):
        # the convex combination weighted by the logits themselves
        import torch.nn.functional as F
        _, _, h, w = flow.shape
        m = 0.25 * mask.float().reshape(9, 64, h, w)
        f8 = F.pad(8 * flow[0], (1, 1, 1, 1))
        up = sum(m[k][None] * f8[:, None, k // 3:k // 3 + h,
                                 k % 3:k % 3 + w] for k in range(9))
        return up.reshape(2, 8, 8, h, w).permute(0, 3, 1, 4, 2).reshape(
            1, 2, 8 * h, 8 * w)
    return call


def _uniform_mask_fault(upsample):
    def call(flow, mask):
        import torch
        return upsample(flow, torch.zeros_like(mask))
    return call


# config 7's planted faults: (name, the attribute of models/raft.py
# replaced, its replacement made from it, whether the benchmark's check
# must refuse it).  Uniform weights smooth the flow within each 3 x 3
# neighbourhood: at 160 x 128 on the CPU they moved 1.3% of the bytes more
# than a code, under the limit; the card's 1080p reading is reported
C7_FAULTS = (
    ("11 updates in place of 12", "ITERS", _iters_fault, True),
    ("the GRU's z gate forced to 0", "gru_update", _z_closed_fault, True),
    ("lookup level 1 one pixel off in x", "corr_lookup", _level_shift_fault,
     True),
    ("the upsampling's softmax dropped", "convex_upsample",
     _no_softmax_fault, True),
    ("the upsampling's mask dropped (weights 1/9)", "convex_upsample",
     _uniform_mask_fault, False),
)


def _dup(x):
    """A copy of a kernel's argument with its strides (a channel slice
    stays a slice's layout); lists and tensors past 256 MB, which the
    kernels only read, are shared."""
    import torch
    if not isinstance(x, torch.Tensor) or x.numel() * x.element_size() > (
            256 << 20):
        return x
    y = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                            device=x.device)
    return y.copy_(x)


def _same_bits(a, b) -> bool:
    import torch
    ints = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()])))


def config7_phase(tag: str = "") -> dict:
    """Phase 4's config 7: RAFT's flow, the benchmark's configuration
    (1920x1080 -> 3840x2160, the recipe's weights) on C7_PAIRS pairs of its
    bank, with the stream cache.  RAFT's five kernels against their plain
    versions on the arguments the path gives them (each kernel's last call
    in an eager flow over the first pair): bitwise, timed (device ms a
    call, CUDA events) beside their bound; the seeded flow's median |F| in
    px.  The kernel step (the flow as one CUDA graph replay) against the
    plain step (in ``plain_versions()``): every output and the last cache
    bitwise; the kernels' launches (C7_GRAPHED, C7_EAGER) read from a
    zeroed start, and none on the plain run.  Then the benchmark's check
    (``fgbench.check.compare`` against ``fgbench/reference/raft_flow.py``
    in bf16) on the kernel path's outputs within the configuration's
    limit, the reference in fp8 (the control) past it, and the kernel path
    with each planted fault of C7_FAULTS (each moves the output; those
    marked caught read past the limit).  Returns the readings, the median
    |F| and the kernels' summary rows."""
    import torch

    from fgbench import check as fg_check
    from fgbench import counts_raft
    from fgbench import load as fg_load
    from fgbench.reference import raft_flow
    from tpufg_torch.config import EngineConfig
    from tpufg_torch.engine.pipeline import (RaftFlow, make_interp_step,
                                             make_q_init)
    from tpufg_torch.kernels import (convex_upsample, corr_lookup, corr_pool,
                                     raft_gru)
    from tpufg_torch.kernels.common import plain_versions
    from tpufg_torch.kernels.convert import frames_to_planar
    from tpufg_torch.kernels.lanczos import lanczos_scale_packed
    from tpufg_torch.kernels.pack import pack_nhwc
    from tpufg_torch.kernels.prelu import bias_prelu
    from tpufg_torch.kernels.warp_grid import warp_frames
    from tpufg_torch.models import raft, rife

    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.abspath(__file__))
    conf = json.load(open(os.path.join(root, C7_CONFIG)))
    cfg = EngineConfig(**conf["engine"]).validate()
    h, w = cfg.input_height, cfg.input_width
    oh, ow = cfg.output_height, cfg.output_width
    params = rife.load_params(os.path.join(root, conf["checkpoint"]))
    pdev = rife.params_to_torch(params, dev)
    bank = fg_load.make_bank(C7_SEED, h, w, C7_PAIRS + 1, 5, dev)
    wires = [torch.from_numpy(b.view(np.int32).reshape(h, w)).to(dev)
             for b in bank]
    limit = conf["limits"]["bad_byte_share"]

    # the five kernels on the arguments the path gives them
    twins = {"corr_lookup": (corr_lookup.corr_lookup,
                             corr_lookup.corr_lookup_plain),
             "corr_pool": (corr_pool.corr_pool, corr_pool.corr_pool_plain),
             "convex_upsample": (convex_upsample.convex_upsample,
                                 convex_upsample.convex_upsample_plain),
             "gru_gates": (raft_gru.gru_gates, raft_gru.gru_gates_plain),
             "gru_update": (raft_gru.gru_update, raft_gru.gru_update_plain)}
    seen = {}

    def recorder(name, fn):
        def call(*args):
            seen[name] = [_dup(a) for a in args]
            return fn(*args)
        return call

    with torch.no_grad():
        for name, (fn, _) in twins.items():
            setattr(raft, name, recorder(name, fn))
        try:
            p0, c1 = frames_to_planar(wires[0]), frames_to_planar(wires[1])
            q0 = raft.frame_cache(pdev, raft.pad_rgb(p0))
            flow, _ = RaftFlow(pdev)(q0, c1)
            torch.cuda.synchronize()
        finally:
            for name, (fn, _) in twins.items():
                setattr(raft, name, fn)
    mag = torch.sqrt(flow[0] ** 2 + flow[1] ** 2)
    median_f = float(mag.median())
    print(f"phase 4: config 7 seeded flow at {w}x{h}: median |F| "
          f"{median_f:.3f} px, mean {float(mag.mean()):.3f}, max "
          f"{float(mag.max()):.3f}, NaN {int(mag.isnan().sum())} {tag}")
    check(not bool(mag.isnan().any()), "config 7: the seeded flow has NaNs")
    del flow, mag, q0

    # bytes a call: each input read once, each output written once
    n8 = (h // 8) * (w // 8)
    copy = len(seen["gru_update"]) > 6 and seen["gru_update"][6] is not None
    nbytes = {"corr_lookup": counts_raft.lookup_bytes(h, w) / 12,
              "corr_pool": seen["corr_pool"][0].numel() * 4 * (
                  1 + 1 / 4 + 1 / 16 + 1 / 64),
              "convex_upsample": counts_raft.upsample_bytes(h, w),
              # r, h in; r h out
              "gru_gates": n8 * 128 * (2 + 4 + 2),
              # z, q, h in; h, its bf16 copies out
              "gru_update": n8 * 128 * (2 + 2 + 4 + 4 + 2 + 2 * copy)}

    def flat(r, args):
        r = list(r) if isinstance(r, (list, tuple)) else [r]
        return r + [a for a in args if isinstance(a, torch.Tensor)]

    rows = []
    with torch.no_grad():
        for name, (fn, plain) in twins.items():
            ka = [_dup(a) for a in seen[name]]
            pa = [_dup(a) for a in seen[name]]
            got, want = flat(fn(*ka), ka), flat(plain(*pa), pa)
            torch.cuda.synchronize()
            same = len(got) == len(want) and all(
                _same_bits(a, b) for a, b in zip(got, want))
            del got, want
            ms = time_ms(lambda: fn(*ka), n=20, warmup=2)
            plain_ms = time_ms(lambda: plain(*pa), n=3, warmup=1)
            bms, by = bound(nbytes[name], 0)
            shapes = [tuple(a.shape) for a in seen[name]
                      if isinstance(a, torch.Tensor)]
            print(f"phase 4: config 7 {name} on the path's arguments "
                  f"{shapes}: bitwise {same}; {ms:.4f} ms a call, plain "
                  f"{plain_ms:.4f}, bound {bms:.4f} ms ({by}), "
                  f"{100 * bms / ms:.1f}% {tag}")
            check(same, f"config 7: {name} kernel vs plain at the path's "
                  "shapes")
            rows.append({"name": name, "route": "cuda",
                         "source": f"tpufg_torch/csrc/"
                                   f"{'raft_gru' if 'gru' in name else name}"
                                   ".cu",
                         "replaces": "RAFT core/ (no TPU kernel)",
                         "launches": C7_GRAPHED[name], "max_abs_err": 0.0,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": None})
            del ka, pa
    del seen
    torch.cuda.empty_cache()

    graphed = (corr_lookup.corr_lookup, corr_pool.corr_pool,
               convex_upsample.convex_upsample, raft_gru.gru_gates,
               raft_gru.gru_update, bias_prelu, pack_nhwc)
    eager = (frames_to_planar, warp_frames, lanczos_scale_packed)

    def run(scope=contextlib.nullcontext):
        step = make_interp_step(cfg, wire="i32", device=dev,
                                model_params=params, q_feed=True)
        outs = []
        with scope():
            q = make_q_init(cfg, params, dev)(wires[0])
            for fn in graphed + eager:
                fn.launches = 0
            for i in range(C7_PAIRS):
                *o, q = step(wires[i], wires[i + 1], q)
                outs.append([t.clone() for t in o])
            q = [t.clone() for t in q]
        torch.cuda.synchronize()
        return outs, q, {fn.__name__: fn.launches for fn in graphed + eager}

    def kept(outs):
        return {i + 1: [o.cpu().numpy().view(np.uint8).reshape(oh, ow, 4)
                        for o in pair] for i, pair in enumerate(outs)}

    def compare(frames, prec="bf16"):
        ref = raft_flow.make(conf, prec, dev, root)
        with torch.no_grad():
            return fg_check.compare(frames, "rgba", bank, ref, dev)

    with torch.no_grad():
        outs_k, q_k, launches = run()
        outs_p, q_p, launches_p = run(plain_versions)
    want = {**{k: v * (C7_PAIRS + 1) for k, v in C7_GRAPHED.items()},
            **{k: v * C7_PAIRS for k, v in C7_EAGER.items()}}
    print(f"phase 4: config 7 launches over {C7_PAIRS} pairs (the flow's "
          f"graph: pairs + its warm-up): {launches}; plain run {launches_p}")
    check(launches == want, "config 7: kernel launches a pair")
    check(not any(launches_p.values()), "config 7: the plain path launched "
          "a kernel")
    for i, (ok, op) in enumerate(zip(outs_k, outs_p)):
        mx, nd, nb = byte_diff(ok[0], op[0])
        print(f"phase 4: config 7 pair {i}: midpoint kernel vs plain max "
              f"|d| {mx}, {nd} of {nb} bytes differ")
        check(nd == 0 and all(torch.equal(a, b) for a, b in zip(ok, op)),
              f"config 7 pair {i}: outputs kernel vs plain")
    check(all(_same_bits(a, b) for a, b in zip(q_k, q_p)),
          "config 7: stream cache kernel vs plain")
    print("phase 4: config 7 kernel path bitwise to the plain path "
          "(midpoints, curr, the last stream cache)")

    frames_k = kept(outs_k)
    del outs_p, q_p
    reading = {"program": compare(frames_k), "fp8": compare(frames_k, "fp8")}
    moved = {}
    for name, attr, wrap, _ in C7_FAULTS:
        orig = getattr(raft, attr)
        setattr(raft, attr, wrap(orig))
        try:
            with torch.no_grad():
                outs_f, _, _ = run()
        finally:
            setattr(raft, attr, orig)
        gaps = [(a[0].view(torch.uint8).to(torch.int16)
                 - b[0].view(torch.uint8).to(torch.int16)).abs()
                for a, b in zip(outs_f, outs_k)]
        n = sum(g.numel() for g in gaps)
        moved[name] = (sum(int((g > 0).sum()) for g in gaps) / n,
                       sum(int((g > 1).sum()) for g in gaps) / n)
        reading[name] = compare(kept(outs_f))
        del outs_f, gaps
    for name, r in reading.items():
        print(f"phase 4: config 7 check, {name}: bad_byte_share "
              f"{r['bad_byte_share']:.6f} (limit {limit}), max_code_gap "
              f"{r['max_code_gap']}, bytes {r['bytes_compared']}"
              + ("; midpoint bytes changed from the program's {:.6f}, by "
                 "more than a code {:.6f}".format(*moved[name])
                 if name in moved else "") + f" {tag}")
    check(reading["program"]["missing_frames"] == 0,
          "config 7: check frames missing")
    check(reading["program"]["bad_byte_share"] <= limit,
          "config 7: the kernel path fails the benchmark's check")
    check(reading["fp8"]["bad_byte_share"] > limit,
          "config 7: the fp8 control passes the benchmark's check")
    for name, _, _, caught in C7_FAULTS:
        check(moved[name][0] > 0, f"config 7: {name}: the output did not "
              "move")
        if caught:
            check(reading[name]["bad_byte_share"] > limit,
                  f"config 7: {name}: passes the benchmark's check")
    return {"reading": reading, "median_flow_px": median_f, "rows": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    import tpufg_torch.kernels as K
    from tpufg_torch.config import EngineConfig
    from tpufg_torch.engine import pipeline
    from tpufg_torch.engine.pipeline import (interp_planar, make_interp_step,
                                             make_q_init)
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels.common import plain_versions
    from tpufg_torch.kernels.conv import (conv3x3_chain, conv3x3_chain_plain,
                                          conv3x3_s2, conv3x3_s2_plain,
                                          packed_s2_weights)
    from tpufg_torch.kernels.convert import (frames_to_planar,
                                             frames_to_planar_plain,
                                             planar_to_i32)
    from tpufg_torch.kernels.lanczos import (lanczos_scale_fast,
                                             lanczos_scale_fast_plain,
                                             lanczos_plan,
                                             lanczos_scale_packed,
                                             lanczos_scale_packed_plain,
                                             planar_plan, tile_smem_bytes)
    from tpufg_torch.kernels.motion import (motion_search_sites,
                                            motion_search_sites_plain,
                                            motion_search_tiled,
                                            motion_search_tiled_plain,
                                            sites_plan, sites_tile_w)
    from tpufg_torch.kernels.resize import (box_downsample2,
                                            box_downsample2_plain)
    from tpufg_torch.kernels.warp import (warp_blend_block,
                                          warp_blend_block_plain)
    from tpufg_torch.kernels.motion_xla import motion_search_lattice
    from tpufg_torch.kernels.warp_matmul import (warp_blend_matmul,
                                                 warp_blend_matmul_plain,
                                                 warp_epilogue,
                                                 warp_epilogue_plain,
                                                 warp_obmc, warp_obmc_plain)
    from tpufg_torch.kernels.resize import resize_linear
    from tpufg_torch.models import rife
    from tpufg_torch.models.pyramid import median_filter_mv, subpel_refine
    from tpufg_torch.engine import runner
    from tpufg_torch.engine.pipeline import mv_lattice_shape
    from tpufg_torch.io.sinks import _down2x2, _rgb_to_bt601
    from tpufg_torch.kernels.yuv import (rgba_to_y4m_payload,
                                         rgba_to_y4m_payload_plain)
    from tpufg_torch.kernels.oracle import (oracle_scale, oracle_scale_plain,
                                            oracle_warp, oracle_warp_plain)
    from tpufg_torch.ops import oracle
    from tpufg_torch.utils.tracing import debug_checks, module_durations_ms
    from tpufg_torch import validate

    # the kernel path, then the plain path (the wrappers' plain versions)
    paths = {"kernel": contextlib.nullcontext, "plain": plain_versions}
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(f"phase 1: card {card!r}, torch.cuda.get_device_name(0) {kind!r}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    so = common.build_library()
    common.cuda_lib()
    print(f"phase 1: built {so.name} in {time.perf_counter() - t0:.2f} s "
          "(includes the check for an existing build)")
    print(so.with_suffix(".log").read_text().strip())
    lib = common.cuda_lib()
    for c in (4, 3):
        dy_block, smem = sites_plan(RADIUS)
        print(f"phase 1: sites kernel C={c} r={RADIUS}: {dy_block} dy per "
              f"block, {smem} bytes of shared memory, "
              f"{lib.tpufg_motion_sites_blocks_per_sm(c, smem)} blocks of 128 "
              "threads per SM")
    for (ih, iw), (oh, ow) in (((IN_H, IN_W), (OUT_H, OUT_W)),
                               ((IN_H, IN_W), (1440, 2560))):
        plan = lanczos_plan(ih, iw, oh, ow, 3)
        print(f"phase 1: packed Lanczos {ih}x{iw}->{oh}x{ow}: {plan}, "
              f"{lib.tpufg_lanczos_packed_blocks_per_sm(6, plan.smem)} blocks "
              f"of {plan.tile_w} threads per SM")
    # config 4q's two warp kernels: registers, spills and blocks per SM
    for label, mode in (("pair", 2), ("blend", 1), ("single", 0)):
        regs, per_sm, spill = (lib.tpufg_warp_obmc_occupancy(mode, 1, 4, i)
                               for i in range(3))
        print(f"phase 1: warp_obmc {label} bf16 C=4: {regs} registers, "
              f"{spill} bytes of local memory a thread, {per_sm} blocks of "
              f"128 threads per SM")
    for label, kernel, threads in (("cells pass", 0, 512),
                                   ("blend, occlusion + fallback", 1, 256)):
        regs, per_sm, spill = (lib.tpufg_warp_epilogue_occupancy(kernel, i)
                               for i in range(3))
        print(f"phase 1: warp_epilogue {label}: {regs} registers, {spill} "
              f"bytes of local memory a thread, {per_sm} blocks of "
              f"{threads} threads per SM")
    for label, c420, vec in (("C420", 1, 1), ("C444", 0, 1),
                             ("C420 scalar walk", 1, 0)):
        regs, per_sm, spill = (lib.tpufg_yuv_occupancy(c420, vec, i)
                               for i in range(3))
        print(f"phase 1: y4m egress {label}: {regs} registers, {spill} bytes "
              f"of local memory a thread, {per_sm} blocks of 256 threads "
              "per SM")
    for label, occ in (("oracle_scale", lib.tpufg_oracle_scale_occupancy),
                       ("oracle_warp", lib.tpufg_oracle_warp_occupancy)):
        regs, per_sm, spill = (occ(i) for i in range(3))
        print(f"phase 1: exact path {label}: {regs} registers, {spill} "
              f"bytes of local memory a thread, {per_sm} blocks of 256 "
              "threads per SM")
        check(min(regs, per_sm, spill) >= 0, f"{label}: occupancy query")
    for (c, ih, iw), (oh, ow), dt in PLANAR_SHAPES:
        group, plan = planar_plan(c, ih, iw, oh, ow, 3)
        per_sm = lib.tpufg_lanczos_planar_blocks_per_sm(
            6, group, int(dt == "bf16"), tile_smem_bytes(plan, 6, group))
        print(f"phase 1: planar Lanczos [{c},{ih},{iw}]->{oh}x{ow} {dt}: "
              f"{group} channels a block, {plan}, "
              + (f"{per_sm} blocks of {plan.tile_w} threads per SM"
                 if plan.tile_rows else "the direct stencil"))

    # ---- phase 2: each kernel vs its plain version at the paths' shapes
    rng = np.random.default_rng(0)
    wire = torch.from_numpy(rng.integers(
        0, 2 ** 32, (IN_H, IN_W), dtype=np.uint32).view(np.int32)).to(dev)
    k, p = frames_to_planar(wire), frames_to_planar_plain(wire)
    check(bits_equal(k, p), "unpack kernel != plain at 1080x1920")
    unpack_err = float((k - p).abs().max())
    print(f"phase 2: unpack [1080,1920] bitwise equal (max |d| {unpack_err})")

    def codes(shape):
        q = rng.integers(0, 256, shape).astype(np.float32)
        return torch.from_numpy(q * np.float32(1 / 255)).to(dev)

    box_err = 0.0
    box_in = {}
    for shape in ((4, 1088, 1920), (4, 544, 960)):
        x = codes(shape)
        box_in[shape] = x
        k, p = box_downsample2(x), box_downsample2_plain(x)
        check(bits_equal(k, p), f"box2 kernel != plain at {shape}")
        box_err = max(box_err, float((k - p).abs().max()))
        print(f"phase 2: box2 {list(shape)} bitwise equal")

    # the three upscales that are timed, then a = 2 and two downscales: at
    # 0.75x the plan still walks tiles, at 0.5x it picks the direct stencil
    lanczos_err = 0
    scale_in = {}
    for (ih, iw), (oh, ow), a in (((1080, 1920), (2160, 3840), 3),
                                  ((720, 1280), (1440, 2560), 3),
                                  ((1080, 1920), (1440, 2560), 3),
                                  ((1080, 1920), (2160, 3840), 2),
                                  ((1440, 2560), (1080, 1920), 3),
                                  ((2160, 3840), (1080, 1920), 3)):
        x = codes((4, ih, iw))
        scale_in[(ih, iw, oh, ow, a)] = x
        plan = lanczos_plan(ih, iw, oh, ow, a)
        k = lanczos_scale_packed(x, oh, ow, a, raw_i32=True)
        p = lanczos_scale_packed_plain(x, oh, ow, a, raw_i32=True)
        mx, nd, nb = byte_diff(k, p)
        print(f"phase 2: lanczos [4,{ih},{iw}] -> {oh}x{ow} a={a} "
              f"({'tile walk' if plan.tile_rows else 'direct stencil'}, "
              f"{plan}): max |d| {mx} code, {nd} of {nb} bytes differ")
        check(nd == 0, f"lanczos kernel vs plain at {ih}x{iw}->{oh}x{ow} "
              f"a={a}")
        check(bool(plan.tile_rows) == (ih < 2 * oh),
              f"lanczos plan at {ih}x{iw}->{oh}x{ow}")
        lanczos_err = max(lanczos_err, mx)

    fast_err = 0.0
    fast_in = {}
    for (c, ih, iw), (oh, ow), dt_name in PLANAR_SHAPES:
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
        x = codes((c, ih, iw)).to(dt)
        fast_in[(c, ih, iw, oh, ow, dt)] = x
        group, plan = planar_plan(c, ih, iw, oh, ow, 3)
        k = lanczos_scale_fast(x, oh, ow)
        p = lanczos_scale_fast_plain(x, oh, ow)
        check(k.dtype == p.dtype == dt and k.shape == p.shape
              and torch.equal(k.view(torch.int16), p.view(torch.int16)),
              f"lanczos_scale_fast kernel != plain at [{c},{ih},{iw}] {dt}")
        check(bool(plan.tile_rows) == (ih < 4 * oh),
              f"planar lanczos plan at [{c},{ih},{iw}]->{oh}x{ow}")
        fast_err = max(fast_err, float((k.float() - p.float()).abs().max()))
        print(f"phase 2: lanczos_scale_fast [{c},{ih},{iw}] -> {oh}x{ow} "
              f"{dt} bitwise equal ("
              + (f"tile walk, {group} channels a block" if plan.tile_rows
                 else "direct stencil") + ")")

    def moved_pair(shape):
        # curr = prev moved by (-2, 3) with an unrelated band on top, so
        # some blocks have a zero-cost winner and some have none
        prev = codes(shape)
        curr = torch.roll(prev, (3, -2), (1, 2))
        curr[:, :16] = codes((shape[0], 16, shape[2]))
        return prev, curr

    motion_in = {}
    sites_err = 0.0
    # the two timed shapes, then a frame whose last strip is ragged at
    # C = 3, and r = 4 (a radius the dy blocks divide unevenly too)
    for shape, r in (((4, 1088, 1920), RADIUS), ((3, 1088, 1920), RADIUS),
                     ((3, 544, 1000), RADIUS), ((4, 1088, 1920), 4)):
        pr, cu = moved_pair(shape)
        if r == RADIUS and shape[1:] == (1088, 1920):
            motion_in[("sites",) + shape] = (pr, cu)
        k = motion_search_sites(pr, cu, search_radius=r, dx_chunk=3)
        p = motion_search_sites_plain(pr, cu, search_radius=r)
        check(bits_equal(k, p), f"sites kernel != plain at {shape} r={r}")
        sites_err = max(sites_err, float((k - p).abs().max()))
        print(f"phase 2: sites {list(shape)} r={r} bitwise equal "
              f"(zero MVs {float((k == 0).all(0).float().mean()):.4f})")
    tiled_err = 0.0
    # the last: the exact path's search (its MV field is every pixel's)
    for shape, b, r, exact in (((4, 1088, 1920), 16, RADIUS, False),
                               ((4, 272, 480), 12, 4, False),
                               ((4, 256, 512), 8, RADIUS, True),
                               ((4, IN_H, IN_W), 8, RADIUS, True)):
        pr, cu = moved_pair(shape)
        motion_in[("tiled", b, r, exact) + shape] = (pr, cu)
        k = motion_search_tiled(pr, cu, block_size=b, search_radius=r,
                                exact_box=exact)
        p = motion_search_tiled_plain(pr, cu, b, r, exact_box=exact)
        check(bits_equal(k, p), f"tiled kernel != plain at {shape} b={b} "
              f"r={r} exact_box={exact}")
        tiled_err = max(tiled_err, float((k - p).abs().max()))
        if exact and shape[1:] == (IN_H, IN_W):
            tiled_exact_err = float((k - p).abs().max())
        print(f"phase 2: tiled {list(shape)} b={b} r={r} exact_box={exact} "
              "bitwise equal")

    # the convs with the bundled head's weights
    head = rife.params_to_torch(rife.load_params(rife.bundled_checkpoint()),
                                dev)
    conv_in = {}
    s2_err = 0.0
    # enc1 at the path's shape in bf16 and at a quarter of it in f32 (270
    # output rows: ragged tiles), then a v1 head's first layer, 8 input
    # channels, with weights from the seed
    w8 = torch.from_numpy(rng.normal(0, .2, (32, 8, 3, 3)).astype(
        np.float32)).to(dev)
    b8 = torch.from_numpy(rng.normal(0, .1, (32,)).astype(np.float32)).to(dev)
    s2_cases = (((4, 2160, 3840), torch.bfloat16, head["enc1"]["w"],
                 head["enc1"]["b"]),
                ((4, 540, 960), torch.float32, head["enc1"]["w"],
                 head["enc1"]["b"]),
                ((8, 1080, 1920), torch.bfloat16, w8, b8))
    for shape, dt, w_, b_ in s2_cases:
        x = codes(shape)
        conv_in[("s2", shape[0], dt)] = (x, w_, b_)
        k = conv3x3_s2(x, w_, b_, compute_dtype=dt)
        p = conv3x3_s2_plain(x, w_, b_, compute_dtype=dt)
        rel, p999 = rel_err(k, p)
        print(f"phase 2: conv3x3_s2 {list(shape)} -> {list(k.shape)} {dt}: "
              f"max |d| / max |ref| {rel:.3e}, p99.9 |d| {p999:.3e}")
        check(k.shape == p.shape and rel <= S2_MAX_REL,
              f"conv3x3_s2 kernel vs plain at {shape} {dt}")
        check(packed_s2_weights(w_, b_, dt, dev)
              is packed_s2_weights(w_, b_, dt, dev),
              "conv3x3_s2: the weights were packed anew")
        if shape[0] == 4 and dt == torch.bfloat16:
            s2_err = float((k - p).abs().max())
    chain_w = tuple(head[n]["w"] for n in ("r_in", "r_body", "r_head"))
    chain_b = tuple(head[n]["b"] for n in ("r_in", "r_body", "r_head"))
    x = torch.from_numpy(rng.standard_normal((17, 540, 960)).astype(
        np.float32)).to(dev)
    conv_in["chain"] = x
    # a v3 head's stage 2 takes 13 channels (no warped difference): the
    # first 13 of the input and of r_in's weights
    x13 = x[:13].contiguous()
    chain_w13 = (chain_w[0][:, :13].contiguous(),) + chain_w[1:]
    chain_err = 0.0
    for xin, cw, dt, tag_dt in ((x, chain_w, torch.bfloat16, "bf16"),
                                (x13, chain_w13, torch.bfloat16, "bf16"),
                                (x, chain_w, torch.float32, "f32")):
        k = conv3x3_chain(xin, cw, chain_b, compute_dtype=dt)
        p = conv3x3_chain_plain(xin, cw, chain_b, compute_dtype=dt)
        rel, p999 = rel_err(k, p)
        print(f"phase 2: conv3x3_chain {list(xin.shape)} -> 64 -> 64 -> "
              f"{list(k.shape)} {tag_dt}: max |d| / max |ref| {rel:.3e}, "
              f"p99.9 |d| {p999:.3e}")
        check(k.shape == p.shape and rel <= CHAIN_MAX_REL[tag_dt],
              f"conv3x3_chain kernel vs plain {list(xin.shape)} {tag_dt}")
        if dt == torch.bfloat16:
            chain_err = max(chain_err, float((k - p).abs().max()))

    # the block warp: random quarter-pel MVs in [-16, 16], blend and single
    wp_prev, wp_curr = codes((4, API_H, IN_W)), codes((4, API_H, IN_W))
    wp_mv = torch.from_numpy((rng.integers(-4 * RADIUS, 4 * RADIUS + 1,
                                           (2, API_H // 16, IN_W // 16))
                              / 4).astype(np.float32)).to(dev)
    warp_err = 0.0
    for label, kw in BLOCK_WARP_MODES.items():
        k = warp_blend_block(wp_prev, wp_curr, wp_mv, search_radius=RADIUS,
                             **kw)
        p = warp_blend_block_plain(wp_prev, wp_curr, wp_mv,
                                   search_radius=RADIUS, **kw)
        check(bits_equal(k, p), f"warp_blend_block kernel != plain {label}")
        warp_err = max(warp_err, float((k - p).abs().max()))
        print(f"phase 2: warp_blend_block [4,{API_H},{IN_W}] b16 r{RADIUS} "
              f"{label} bitwise equal")

    # the engine's warp at each path's shape and mode: MVs past the clip,
    # whole-pixel ones (even for a blend) where the path moves whole pixels
    engine_in = {}
    engine_err = 0.0
    for label, (shape, g, r, whole, kw, crop) in ENGINE_WARPS.items():
        kw = dict(kw, block=g, search_radius=r,
                  dtype=torch.bfloat16 if kw.get("dtype") == "bf16"
                  else torch.float32)
        a, b = codes(shape), codes(shape)
        mv = torch.from_numpy(warp_mvs(rng, shape, g, r, whole,
                                       kw.get("single", False))).to(dev)
        engine_in[label] = (a, b, mv, kw, crop)
        k = warp_blend_matmul(a, b, mv, crop=crop, **kw)
        p = warp_blend_matmul_plain(a, b, mv, crop=crop, **kw)
        check(bits_equal(k, p), f"warp_blend_matmul kernel != plain {label}")
        engine_err = max(engine_err, float((k - p).abs().max()))
        print(f"phase 2: warp_blend_matmul {label} {list(shape)} b{g} r{r} "
              f"{kw['dtype']} crop {crop}: bitwise equal")

    # config 4q's kernels at its shapes: the padded 1080p frame, the MV
    # field on the 8-px lattice (continuous, past the clip).  The per-pixel
    # warp (pair mode is the path's; blend and single the API's), the
    # epilogue on that pair (the path's options, each alone, and t = 0.25),
    # then the engine warp with both options: per-pixel, and the block
    # warps at 16 (--occlusion-blend alone) and 8 (--mv-grid 8)
    q_shape = (4, API_H, IN_W)
    qa, qb = codes(q_shape), codes(q_shape)
    q_mv = {g: torch.from_numpy(warp_mvs(rng, q_shape, g, RADIUS, False,
                                         False)).to(dev) for g in (8, 16)}
    q_crop = (IN_H, IN_W)
    obmc_err = 0.0
    for mode in ("pair", "blend", "single"):
        kw = dict(block=8, search_radius=RADIUS, dtype=torch.bfloat16,
                  single=mode == "single", pair=mode == "pair",
                  crop=None if mode == "pair" else q_crop)
        k = warp_obmc(qa, qb, q_mv[8], **kw)
        p = warp_obmc_plain(qa, qb, q_mv[8], **kw)
        check(bits_equal(k, p), f"warp_obmc kernel != plain {mode}")
        obmc_err = max(obmc_err, float((k - p).abs().max()))
        print(f"phase 2: warp_obmc {list(q_shape)} b8 r{RADIUS} bf16 {mode} "
              f"-> {list(k.shape)}: bitwise equal")
    # the path's form: the pair and the fallback's cell means in one launch
    q_pair, q_cells = warp_obmc(qa, qb, q_mv[8], block=8,
                                search_radius=RADIUS, dtype=torch.bfloat16,
                                pair=True, cells=True)
    p_pair, p_cells = warp_obmc_plain(qa, qb, q_mv[8], block=8,
                                      search_radius=RADIUS,
                                      dtype=torch.bfloat16, pair=True,
                                      cells=True)
    check(bits_equal(q_pair, p_pair) and bits_equal(q_cells, p_cells),
          "warp_obmc kernel != plain: pair and cell means")
    obmc_err = max(obmc_err, float((q_cells - p_cells).abs().max()))
    print(f"phase 2: warp_obmc {list(q_shape)} b8 r{RADIUS} bf16 pair and "
          f"cell means -> {list(q_pair.shape)}, {list(q_cells.shape)}: "
          "bitwise equal")
    epi_err = 0.0
    # (the last with the cell means given, as the path runs it)
    for t, occ, fb, given in ((0.5, True, True, False),
                              (0.5, True, False, False),
                              (0.5, False, True, False),
                              (0.25, True, True, False),
                              (0.5, True, True, True)):
        kw = dict(factor=t, occlusion=occ, mc_fallback=fb, crop=q_crop)
        k = warp_epilogue(q_pair, qa, qb, cells=q_cells if given else None,
                          **kw)
        p = warp_epilogue_plain(q_pair, qa, qb, **kw)
        check(bits_equal(k, p), f"warp_epilogue kernel != plain {kw}")
        epi_err = max(epi_err, float((k - p).abs().max()))
        print(f"phase 2: warp_epilogue t={t} occlusion {occ} fallback {fb} "
              f"cell means {'given' if given else 'made'} {list(q_shape)} "
              f"crop {q_crop}: bitwise equal")
    for label, g, bil in (("per-pixel", 8, True), ("block 16", 16, False),
                          ("block 8", 8, False)):
        kw = dict(factor=0.5, block=g, search_radius=RADIUS,
                  dtype=torch.bfloat16, bilinear=bil, occlusion=True,
                  mc_fallback=True, u8_exact=True, crop=q_crop)
        k = warp_blend_matmul(qa, qb, q_mv[g], **kw)
        p = warp_blend_matmul_plain(qa, qb, q_mv[g], **kw)
        check(bits_equal(k, p), f"warp_blend_matmul {label} with the "
              "options: kernel != plain")
        print(f"phase 2: warp_blend_matmul {label} b{g} occlusion + fallback "
              f"{list(q_shape)} crop {q_crop}: bitwise equal")
    # the y4m egress: random codes at the egress shapes, then every code
    # of each channel with the others at 0 and at 255 (both clips and the
    # arithmetic shift of negative chroma sums), against the plain version
    # and the host egress (io/sinks.py) on the same frame
    yuv_in = {}
    codes_u8 = np.zeros((24, 256, 4), np.uint8)
    for ch in range(3):
        for j, other in enumerate((0, 255)):
            rows = slice(8 * ch + 4 * j, 8 * ch + 4 * j + 4)
            codes_u8[rows] = other
            codes_u8[rows, :, ch] = np.arange(256)
    for (h_, w_), chroma in (((OUT_H, OUT_W), "420"), ((OUT_H, OUT_W), "444"),
                             ((IN_H, IN_W), "420"), ((24, 256), "420"),
                             ((24, 256), "444")):
        f = (codes_u8 if h_ == 24 else
             rng.integers(0, 256, (h_, w_, 4), dtype=np.uint8))
        x = torch.from_numpy(f.view(np.int32).reshape(h_, w_)).to(dev)
        if h_ == OUT_H:
            yuv_in[chroma] = x
        k = rgba_to_y4m_payload(x, chroma)
        p = rgba_to_y4m_payload_plain(x, chroma)
        y, u, v = _rgb_to_bt601(f[..., :3])
        if chroma == "420":
            u, v = _down2x2(u), _down2x2(v)
        host = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        check(torch.equal(k, p), f"y4m egress kernel != plain at {h_}x{w_} "
              f"C{chroma}")
        check(np.array_equal(k.cpu().numpy().ravel(), host),
              f"y4m egress kernel != host egress at {h_}x{w_} C{chroma}")
        print(f"phase 2: y4m egress [{h_},{w_}] C{chroma} -> "
              f"{list(k.shape)}: bitwise equal to the plain version and to "
              "the host egress")
    # the exact path's scale on UNORM8 frames: 1080p -> 4K, 1440p ->
    # 1080p (4:3) and identity (tiny sine weights on the integer taps);
    # then the UNORM8 store's .5 ties and clamps on 1x1 frames (one valid
    # tap of weight 1: the value reaches the store unchanged)
    oracle_in, ex_scale_err = {}, 0
    for (ih, iw), (oh, ow) in (((IN_H, IN_W), (OUT_H, OUT_W)),
                               ((1440, 2560), (IN_H, IN_W)),
                               ((IN_H, IN_W), (IN_H, IN_W))):
        x = codes((ih, iw, 4))
        oracle_in[(ih, iw, oh, ow)] = x
        k, p = oracle_scale(x, oh, ow), oracle_scale_plain(x, oh, ow)
        check(torch.equal(k, p), f"oracle_scale kernel != plain at "
              f"{ih}x{iw}->{oh}x{ow}")
        ex_scale_err = max(ex_scale_err, int((k.int() - p.int()).abs().max()))
        print(f"phase 2: oracle_scale [{ih},{iw},4] -> {oh}x{ow}: bitwise "
              "equal")
    tie = np.arange(255, dtype=np.float32) + np.float32(0.5)
    tie_v = tie / np.float32(255)
    tie_v = tie_v[tie_v * np.float32(255) == tie]     # exact .5 ties
    vals = np.concatenate([tie_v, np.float32([-0.1, 1.2, 0.0, 1.0])])
    vals = np.concatenate([vals, np.zeros(-len(vals) % 4, np.float32)])
    n_even = 0
    for v4 in vals.reshape(-1, 1, 1, 4):
        x = torch.from_numpy(v4).to(dev)
        k, p = oracle_scale(x, 1, 1), oracle_scale_plain(x, 1, 1)
        check(torch.equal(k, p), f"oracle_scale UNORM8 store != plain on "
              f"{v4.ravel().tolist()}")
        n_even += int((k.cpu().numpy().ravel()[np.isin(v4.ravel(), tie_v)]
                       % 2 == 0).sum())
    check(n_even == len(tie_v), "oracle_scale: a .5 tie did not round to "
          "even")
    print(f"phase 2: oracle_scale UNORM8 store: {len(tie_v)} exact .5 ties "
          "each rounded to the even code, the clamps, bitwise equal")
    # the exact path's warp at 1080p: per-pixel MVs up to 24 px, so that
    # samples near every edge leave [0, 1] (the mask); t = 0.25, and 0.5,
    # where prev's and curr's uv steps are one product (not fused); and
    # the crossfade
    ex_a, ex_b = codes((IN_H, IN_W, 4)), codes((IN_H, IN_W, 4))
    ex_mv = torch.from_numpy(rng.uniform(-24, 24, (IN_H, IN_W, 2)).astype(
        np.float32)).to(dev)
    gx = torch.arange(IN_W, device=dev)[None, :] - 0.5 * ex_mv[..., 0]
    oob = float(((gx < 0) | (gx > IN_W - 1)).float().mean())
    ex_warp_err = 0.0
    for t_, mv_ in ((0.25, ex_mv), (0.5, ex_mv), (0.5, None)):
        k, p = oracle_warp(ex_a, ex_b, mv_, t_), oracle_warp_plain(
            ex_a, ex_b, mv_, t_)
        check(bits_equal(k, p), f"oracle_warp kernel != plain at t={t_} "
              f"{'crossfade' if mv_ is None else 'MV'}")
        ex_warp_err = max(ex_warp_err, float((k - p).abs().max()))
        fused = oracle.warp_tables(IN_H, IN_W, t_, dev).fuse_x
        print(f"phase 2: oracle_warp [{IN_H},{IN_W},4] t={t_} "
              + ("crossfade" if mv_ is None else
                 f"per-pixel MVs (uv step fused: {fused}; prev's sample "
                 f"leaves the frame on ~{oob:.4f} of pixels)")
              + ": bitwise equal")
    torch.cuda.synchronize()

    # ---- phase 3: each path through the command line, counts from 0
    kernels = (frames_to_planar, box_downsample2, lanczos_scale_packed,
               motion_search_sites, motion_search_tiled, conv3x3_s2,
               conv3x3_chain, lanczos_scale_fast, warp_blend_block,
               warp_blend_matmul, warp_obmc, warp_epilogue,
               rgba_to_y4m_payload, oracle_scale, oracle_warp)
    no_exact = {"oracle_scale": 0, "oracle_warp": 0}
    no_conv = {"conv3x3_s2": 0, "conv3x3_chain": 0,
               "lanczos_scale_fast": 0, "warp_blend_block": 0,
               "warp_obmc": 0, "warp_epilogue": 0, "rgba_to_y4m_payload": 0,
               **no_exact}
    runs = {}
    # the wrappers look their plain versions up as module globals: count
    # the calls of the warp's, the y4m egress's and the exact path's on the
    # card during the runs (the kernel path must make none)
    from tpufg_torch.kernels import motion as motion_mod
    from tpufg_torch.kernels import oracle as oracle_mod
    from tpufg_torch.kernels import warp_matmul as warp_mod
    from tpufg_torch.kernels import yuv as yuv_mod
    plain_on_card = []

    def counted(fn):
        def call(x, *args, **kwargs):
            plain_on_card.append(x.is_cuda)
            return fn(x, *args, **kwargs)
        return call

    twins = [(mod, name, getattr(mod, name)) for mod, name in (
        (warp_mod, "warp_blend_matmul_plain"),
        (yuv_mod, "rgba_to_y4m_payload_plain"),
        (oracle_mod, "oracle_warp_plain"), (oracle_mod, "oracle_scale_plain"),
        (motion_mod, "motion_search_tiled_plain"))]
    for mod, name, fn in twins:
        setattr(mod, name, counted(fn))
    for name, src, argv, n in (
            ("config 4", f"{IN_W}x{IN_H}", ["--output-width", str(OUT_W),
                                            "--output-height", str(OUT_H)],
             N_FRAMES),
            ("config 4q", f"{IN_W}x{IN_H}", ["--output-width", str(OUT_W),
                                             "--output-height", str(OUT_H),
                                             "--quality", "on",
                                             "--occlusion-blend"],
             Q4_FRAMES),
            ("config 3", f"{IN_W}x{IN_H}", ["--motion-mode", "exhaustive"],
             C3_FRAMES),
            ("config 3 b16", f"{IN_W}x{IN_H}", ["--motion-mode", "exhaustive",
                                                "--block-size", "16"],
             C3_B16_FRAMES),
            ("config 5", f"{OUT_W}x{OUT_H}", ["--motion-mode", "learned"],
             C5_FRAMES),
            # the engine's options
            ("config 4 x4 cut temporal", f"{IN_W}x{IN_H}",
             ["--output-width", str(OUT_W), "--output-height", str(OUT_H),
              "--fps-multiplier", "4", "--scene-cut", str(CUT),
              "--temporal-mv"], T4_FRAMES),
            ("config 5 x3", f"{OUT_W}x{OUT_H}", ["--motion-mode", "learned",
                                                "--fps-multiplier", "3"],
             OPT_FRAMES),
            ("config 3 cut", f"{IN_W}x{IN_H}", ["--motion-mode", "exhaustive",
                                                "--scene-cut", str(CUT)],
             OPT_FRAMES)):
        rc, stats, launches = drive(
            [f"synthetic:{src}", *argv, "--frames", str(n),
             "--no-pacing", "--output", "null"], kernels)
        check(rc == 0, f"{name}: cli exit code {rc}")
        pairs = stats.frames_in - 1
        k_out = 4 if "x4" in name else 3 if "x3" in name else 2
        print(f"phase 3: {name}: cli rc {rc}, frames in {stats.frames_in}, "
              f"out {stats.frames_out}, launches {launches}, graph "
              f"captures {stats.graph_captures}, replays "
              f"{stats.graph_replays}, host fps {stats.fps:.2f} {tag}")
        check(stats.frames_in == n, f"{name}: frames_in")
        check(stats.frames_out == k_out * pairs + 1, f"{name}: frames_out")
        # a step that threads no state between pairs replays every pair
        stateless = "learned" not in argv and "--temporal-mv" not in argv
        check((stats.graph_captures, stats.graph_replays)
              == ((1, pairs) if stateless else (0, 0)),
              f"{name}: graph captures and replays")
        runs[name] = (step_calls(stats), launches)
    # a 4K C420 y4m file: the payloads made by the y4m kernel on the card,
    # then the same run forced onto the host egress (RGBA read back and
    # converted by io/sinks.py): the two files byte for byte; and the
    # overlay, drawn on the host's RGBA frames of a raw file
    import tempfile
    y4m_files = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, host_egress in (("y4m 420", False),
                                  ("y4m 420 host egress", True)):
            out = f"{tmp}/{name.replace(' ', '_')}.y4m"
            negotiate = runner.StreamingEngine._sink_wire
            if host_egress:
                runner.StreamingEngine._sink_wire = lambda self, sink: "rgba"
            try:
                rc, stats, launches = drive(
                    [f"synthetic:{IN_W}x{IN_H}", "--output-width", str(OUT_W),
                     "--output-height", str(OUT_H), "--frames",
                     str(OPT_FRAMES), "--no-pacing", "--output", out,
                     "--y4m-chroma", "420"], kernels)
            finally:
                runner.StreamingEngine._sink_wire = negotiate
            check(rc == 0 and stats.frames_out == 2 * OPT_FRAMES - 1,
                  f"{name}: cli exit code {rc}")
            with open(out, "rb") as fh:
                y4m_files[name] = fh.read()
            runs[name] = (step_calls(stats), launches)
            print(f"phase 3: {name}: cli rc {rc}, frames in "
                  f"{stats.frames_in}, out {stats.frames_out}, "
                  f"{len(y4m_files[name])} bytes, launches {launches} {tag}")
        raw = f"{tmp}/overlay.raw"
        rc, stats, launches = drive(
            [f"synthetic:{IN_W}x{IN_H}", "--frames", "3", "--no-pacing",
             "--overlay", "--output", raw], kernels)
        check(rc == 0 and stats.frames_out == 5, f"--overlay: cli exit code "
              f"{rc}")
        first = np.fromfile(raw, np.uint8, IN_H * IN_W * 4).reshape(
            IN_H, IN_W, 4)
        white = int((first[10:24, 10:400] == 255).all(-1).sum())
        print(f"phase 3: --overlay: cli rc {rc}, frames out "
              f"{stats.frames_out}, {white} white pixels of the stats line "
              f"in the first frame, launches {launches}")
        check(white > 100, "--overlay: no stats line in the frame")
    check(y4m_files["y4m 420"] == y4m_files["y4m 420 host egress"],
          "y4m: the device egress's file differs from the host egress's")
    print(f"phase 3: y4m: the device egress's file equals the host "
          f"egress's ({len(y4m_files['y4m 420'])} bytes)")
    del y4m_files
    # --quality auto: the preset's step rate measured on the card decides
    # (kept where it sustains 1.5x the 60 fps target); its log line
    import io
    log_out = io.StringIO()
    with contextlib.redirect_stdout(log_out):
        rc, stats, _ = drive([f"synthetic:{IN_W}x{IN_H}", "--output-width",
                              str(OUT_W), "--output-height", str(OUT_H),
                              "--quality", "auto", "--frames", "3",
                              "--no-pacing", "--output", "null"], kernels)
    auto_line = [ln for ln in log_out.getvalue().splitlines()
                 if "--quality auto:" in ln]
    check(rc == 0 and stats.frames_in == 3 and len(auto_line) == 1,
          f"--quality auto: cli exit code {rc}, log {log_out.getvalue()!r}")
    print(f"phase 3: --quality auto: cli rc {rc}, {auto_line[0].strip()} "
          f"{tag}")
    # --precision exact: the oracle's step on its three kernels (and the
    # first frame's exact scale step), then the exact scale step alone
    for name, argv in (("exact", []),
                       ("exact scale", ["--no-interpolation"])):
        rc, stats, launches = drive(
            [f"synthetic:{IN_W}x{IN_H}", "--output-width", str(OUT_W),
             "--output-height", str(OUT_H), "--precision", "exact", *argv,
             "--frames", str(EXACT_FRAMES), "--no-pacing", "--output",
             "null"], kernels)
        out_n = (2 * EXACT_FRAMES - 1 if name == "exact" else EXACT_FRAMES)
        check(rc == 0 and stats.frames_in == EXACT_FRAMES
              and stats.frames_out == out_n, f"--precision {name}: cli exit "
              f"code {rc}")
        runs[name] = (step_calls(stats), launches)
        print(f"phase 3: --precision {name}: cli rc {rc}, frames in "
              f"{stats.frames_in}, out {stats.frames_out}, launches "
              f"{launches}, host fps {stats.fps:.2f} {tag}")
    # --trace on config 4, in a process of its own (on the H100, a profiler
    # session with CPU activities left the process's later CUDA-only
    # sessions short of their first record): the trace file and its steps'
    # device durations (read again beside the CUDA-event p50 in phase 5);
    # then --debug-checks: the NaN guard passes a clean run
    with tempfile.TemporaryDirectory() as trace_dir:
        proc = subprocess.run(
            [sys.executable, "-m", "tpufg_torch.cli",
             f"synthetic:{IN_W}x{IN_H}", "--output-width", str(OUT_W),
             "--output-height", str(OUT_H), "--frames", str(TRACE_FRAMES),
             "--no-pacing", "--output", "null", "--trace", trace_dir],
            capture_output=True, text=True, timeout=600)
        done = [ln for ln in proc.stdout.splitlines() if "Done:" in ln]
        check(proc.returncode == 0 and len(done) == 1
              and f"Done: {TRACE_FRAMES} in" in done[0],
              f"--trace: cli exit code {proc.returncode}, "
              f"{proc.stdout[-2000:]!r} {proc.stderr[-2000:]!r}")
        import glob
        trace_files = glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                                recursive=True)
        trace_steps = module_durations_ms(trace_dir).get("tpufg.step", [])
        check(len(trace_files) == 1, f"--trace: trace files {trace_files}")
        check(len(trace_steps) >= 1, "--trace: no tpufg.step span with a "
              "device duration in the trace")
        print(f"phase 3: --trace on config 4: cli rc {proc.returncode}, "
              f"{done[0].split('] ')[-1]}, trace "
              f"{os.path.getsize(trace_files[0])} bytes, {len(trace_steps)} "
              f"tpufg.step spans with a device duration, p50 "
              f"{np.percentile(trace_steps, 50):.4f} ms {tag}")
    rc, stats, launches = drive(
        [f"synthetic:{IN_W}x{IN_H}", "--output-width", str(OUT_W),
         "--output-height", str(OUT_H), "--frames", str(DEBUG_FRAMES),
         "--no-pacing", "--output", "null", "--debug-checks"], kernels)
    check(rc == 0 and stats.frames_in == DEBUG_FRAMES, f"--debug-checks: "
          f"cli exit code {rc}")
    check(stats.graph_captures == stats.graph_replays == 0,
          "--debug-checks: the step ran from a graph")
    runs["config 4 --debug-checks"] = (step_calls(stats), launches)
    print(f"phase 3: --debug-checks on config 4: cli rc {rc}, frames out "
          f"{stats.frames_out}, launches {launches}")
    # a NaN planted in a kernel's input (outside the guard): the launch's
    # own check raises, naming the kernel
    nan_a = ex_a.clone()
    nan_a[7, 9, 2] = float("nan")
    raised = None
    with debug_checks(True):
        try:
            oracle_warp(nan_a, ex_b, None, 0.5)
        except FloatingPointError as e:
            raised = str(e)
    torch.cuda.synchronize()
    check(raised is not None and "tpufg_oracle_warp" in raised,
          f"--debug-checks: a NaN in a kernel's input did not raise at its "
          f"launch ({raised!r})")
    print(f"phase 3: --debug-checks: a NaN planted in oracle_warp's input "
          f"raised FloatingPointError({raised!r})")
    for mod, name, fn in twins:
        setattr(mod, name, fn)
    check(not any(plain_on_card), f"warp_blend_matmul_plain, "
          f"rgba_to_y4m_payload_plain or the exact path's plain versions ran "
          f"{sum(plain_on_card)} times on the card on the kernel path")
    print(f"phase 3: warp_blend_matmul_plain, rgba_to_y4m_payload_plain, "
          f"oracle_warp_plain, oracle_scale_plain and "
          f"motion_search_tiled_plain calls on the card during the runs: "
          f"{sum(plain_on_card)}")
    pairs, launches = runs["config 4"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 4 * pairs,
                       "lanczos_scale_packed": 2 * pairs + 1,
                       "motion_search_sites": 0,
                       "motion_search_tiled": 0, **no_conv,
                       # the refine warp and the blend
                       "warp_blend_matmul": 2 * pairs},
          "config 4 launches")
    pairs, launches = runs["config 4q"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 4 * pairs,
                       "lanczos_scale_packed": 2 * pairs + 1,
                       "motion_search_sites": 0,
                       "motion_search_tiled": 0, **no_conv,
                       # the refine warp and two sub-pel probe warps
                       "warp_blend_matmul": 3 * pairs,
                       # the blend: the per-pixel warp's pair and the
                       # fallback's cell means, then the epilogue
                       "warp_obmc": pairs, "warp_epilogue": pairs},
          "config 4q launches")
    # identity size: the first frame and every curr pass through unscaled
    pairs, launches = runs["config 3"]
    check(launches == {"frames_to_planar": 2 * pairs,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": pairs,
                       "motion_search_tiled": 0, **no_conv,
                       "warp_blend_matmul": pairs},
          "config 3 launches")
    pairs, launches = runs["config 3 b16"]
    check(launches == {"frames_to_planar": 2 * pairs,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": 0,
                       "motion_search_tiled": pairs, **no_conv,
                       "warp_blend_matmul": pairs},
          "config 3 --block-size 16 launches")
    # the stream cache's seed unpacks and encodes the first frame once;
    # then each pair unpacks both frames and encodes curr
    pairs, launches = runs["config 5"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": 0, "motion_search_tiled": 0,
                       "conv3x3_s2": pairs + 1, "conv3x3_chain": pairs,
                       "lanczos_scale_fast": 0, "warp_blend_block": 0,
                       "warp_obmc": 0, "warp_epilogue": 0,
                       "rgba_to_y4m_payload": 0, **no_exact,
                       # two coarse warps and two tail warps
                       "warp_blend_matmul": 4 * pairs},
          "config 5 launches")
    # x4 with the temporal seed: the seeded coarse warp, the refine warp and
    # three blends a pair; Lanczos on three in-between frames and curr
    pairs, launches = runs["config 4 x4 cut temporal"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 4 * pairs,
                       "lanczos_scale_packed": 4 * pairs + 1,
                       "motion_search_sites": 0,
                       "motion_search_tiled": 0, **no_conv,
                       "warp_blend_matmul": 5 * pairs},
          "config 4 x4 cut temporal launches")
    # x3 on the head: two coarse warps, two tail warps per time point
    pairs, launches = runs["config 5 x3"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": 0, "motion_search_tiled": 0,
                       "conv3x3_s2": pairs + 1, "conv3x3_chain": pairs,
                       "lanczos_scale_fast": 0, "warp_blend_block": 0,
                       "warp_obmc": 0, "warp_epilogue": 0,
                       "rgba_to_y4m_payload": 0, **no_exact,
                       "warp_blend_matmul": 6 * pairs},
          "config 5 x3 launches")
    pairs, launches = runs["config 3 cut"]
    check(launches == {"frames_to_planar": 2 * pairs,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": pairs,
                       "motion_search_tiled": 0, **no_conv,
                       "warp_blend_matmul": pairs},
          "config 3 --scene-cut launches")
    # the y4m file: every frame out through the egress kernel (the first
    # frame's scale step too), none on the host egress's run
    for name, per_frame in (("y4m 420", 1), ("y4m 420 host egress", 0)):
        pairs, launches = runs[name]
        check(launches == {"frames_to_planar": 2 * pairs + 1,
                           "box_downsample2": 4 * pairs,
                           "lanczos_scale_packed": 2 * pairs + 1,
                           "motion_search_sites": 0,
                           "motion_search_tiled": 0, **no_conv,
                           "rgba_to_y4m_payload": per_frame * (2 * pairs
                                                               + 1),
                           "warp_blend_matmul": 2 * pairs},
              f"{name} launches")
    # config 4 with --debug-checks: config 4's kernels
    for name in ("config 4 --debug-checks",):
        pairs, launches = runs[name]
        check(launches == {"frames_to_planar": 2 * pairs + 1,
                           "box_downsample2": 4 * pairs,
                           "lanczos_scale_packed": 2 * pairs + 1,
                           "motion_search_sites": 0,
                           "motion_search_tiled": 0, **no_conv,
                           "warp_blend_matmul": 2 * pairs},
              f"{name} launches")
    # the exact step: the tiled search once a pair, the warp once and the
    # scale twice a pair (k = 2), the first frame's scale; nothing else
    pairs, launches = runs["exact"]
    zeros = {fn.__name__: 0 for fn in kernels}
    check(launches == {**zeros, "motion_search_tiled": pairs,
                       "oracle_warp": pairs, "oracle_scale": 2 * pairs + 1},
          "--precision exact launches")
    pairs, launches = runs["exact scale"]
    check(launches == {**zeros, "oracle_scale": pairs + 1},
          "--precision exact --no-interpolation launches")

    # the kernel API path: 1080p pan pairs composed from tpufg_torch.kernels
    api_wires = [torch.from_numpy(f).to(dev)
                 for f in pan_frames(API_PAIRS + 1)]

    def api_pair(prev_wire, curr_wire):
        """Unpack, edge pad 1080 -> 1088 rows, the per-pixel search (block
        16, r 16) read at the block centres, the block warp + blend at
        t = 0.5 with the forward flow, Lanczos to 4K, UNORM8 frames."""
        pp, cp = (F.pad(K.frames_to_planar(w)[None],
                        (0, 0, 0, API_H - IN_H), mode="replicate")[0]
                  for w in (prev_wire, curr_wire))
        mv = K.motion_search_tiled(pp, cp, block_size=16,
                                   search_radius=RADIUS)[:, 8::16, 8::16]
        mid = K.warp_blend_block(pp, cp, -mv, factor=0.5, block=16,
                                 search_radius=RADIUS)[:, :IN_H]
        up = K.lanczos_scale_fast(mid, OUT_H, OUT_W)
        return mv, mid, up, K.planar_to_frames(up)

    for fn in kernels:
        fn.launches = 0
    api_out = [api_pair(api_wires[i], api_wires[i + 1])
               for i in range(API_PAIRS)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"phase 3: kernel API: {API_PAIRS} pairs 1080p -> 4K, launches "
          f"{launches}")
    check(launches == {"frames_to_planar": 2 * API_PAIRS,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": 0,
                       "motion_search_tiled": API_PAIRS,
                       "conv3x3_s2": 0, "conv3x3_chain": 0,
                       "lanczos_scale_fast": API_PAIRS,
                       "warp_blend_block": API_PAIRS,
                       "warp_blend_matmul": 0, "warp_obmc": 0,
                       "warp_epilogue": 0, "rgba_to_y4m_payload": 0,
                       **no_exact},
          "kernel API launches")
    runs["kernel API"] = (API_PAIRS, launches)
    for i, (mv, mid, up, frames4k) in enumerate(api_out):
        hit = pan_mv_hit(mv)
        same = midpoint_match(mid, api_wires[i], as_bytes=False)
        packed = lanczos_scale_packed(mid.contiguous(), OUT_H, OUT_W)
        mx, nd, nb = byte_diff(frames4k, packed)
        print(f"phase 3: kernel API pair {i}: pan MV hit rate {hit:.4f}, "
              f"midpoint == shifted source on {same:.4f}, 4K frame "
              f"{tuple(frames4k.shape)} vs the packed Lanczos kernel: "
              f"{nd} of {nb} bytes differ")
        check(tuple(up.shape) == (4, OUT_H, OUT_W)
              and bool(torch.isfinite(up).all()), "kernel API: 4K output")
        check(hit >= 0.95, "kernel API: pan MV not recovered")
        check(same >= 0.99, "kernel API: midpoint does not match the "
              "shifted source")
        check(nd == 0, "kernel API: planar and packed Lanczos bytes differ")
    path_launches = {
        "unpack": runs["config 4"][1]["frames_to_planar"],
        "box2": runs["config 4"][1]["box_downsample2"],
        "lanczos_packed": runs["config 4"][1]["lanczos_scale_packed"],
        "motion_sites": runs["config 3"][1]["motion_search_sites"],
        "motion_tiled": runs["config 3 b16"][1]["motion_search_tiled"],
        "conv_s2": runs["config 5"][1]["conv3x3_s2"],
        "conv_chain": runs["config 5"][1]["conv3x3_chain"],
        "lanczos_planar": runs["kernel API"][1]["lanczos_scale_fast"],
        "warp_block": runs["kernel API"][1]["warp_blend_block"],
        "warp_matmul": runs["config 5"][1]["warp_blend_matmul"],
        "warp_obmc": runs["config 4q"][1]["warp_obmc"],
        "warp_epilogue": runs["config 4q"][1]["warp_epilogue"],
        "yuv": runs["y4m 420"][1]["rgba_to_y4m_payload"],
        "oracle_scale": runs["exact"][1]["oracle_scale"],
        "oracle_warp": runs["exact"][1]["oracle_warp"],
        "motion_tiled_exact": runs["exact"][1]["motion_search_tiled"]}

    # ---- phase 4: kernel path vs plain path, and a known answer
    frames = [torch.from_numpy(f).to(dev) for f in pan_frames(3)]
    cfgs = {
        "config 4": (EngineConfig(input_width=IN_W, input_height=IN_H,
                                  output_width=OUT_W, output_height=OUT_H),
                     (OUT_H, OUT_W)),
        "config 3": (EngineConfig(input_width=IN_W, input_height=IN_H,
                                  output_width=IN_W, output_height=IN_H,
                                  motion_mode="exhaustive"), (IN_H, IN_W)),
    }
    for name, (cfg, out_hw) in cfgs.items():
        step = make_interp_step(cfg, wire="i32", device=dev)
        for i in range(2):
            prev, curr = frames[i], frames[i + 1]
            mvs, mids = [], []
            for scope in paths.values():
                with scope():
                    mid, mv = interp_planar(
                        frames_to_planar(prev), frames_to_planar(curr),
                        mode=cfg.motion_mode, factors=[0.5],
                        dt=torch.bfloat16, block_size=8,
                        search_radius=RADIUS, return_mv=True)
                mvs.append(mv)
                mids.append(mid[0])
            check(bits_equal(mvs[0], mvs[1]), f"{name} pair {i}: MV fields "
                  "differ")
            outs_k, outs_p = (in_scope(scope, step, prev, curr)
                              for scope in paths.values())
            for ok_, op_ in zip(outs_k, outs_p):
                check(tuple(ok_.shape) == out_hw, f"{name}: output shape")
                mx, nd, nb = byte_diff(ok_, op_)
                check(mx <= 1, f"{name} pair {i}: kernel vs plain output "
                      f"bytes {mx}")
            check(bool(torch.isfinite(mids[0]).all()),
                  f"{name}: in-between frame not finite")
            hit = pan_mv_hit(mvs[0])
            same = midpoint_match(mids[0], prev,
                                  as_bytes=cfg.motion_mode == "exhaustive")
            print(f"phase 4: {name} pair {i}: MV bitwise equal, outputs "
                  f"within 1 code (last pair {nd} of {nb} bytes differ); pan "
                  f"MV hit rate {hit:.4f}, midpoint == shifted source on "
                  f"{same:.4f}")
            check(hit >= 0.95, f"{name}: pan MV not recovered")
            check(same >= 0.99, f"{name}: midpoint does not match the "
                  "shifted source")

    # config 4q: the kernel path against the plain path on the (4, 2) pan
    # (its sub-pel MVs are not the pan's integers), then the known answer
    cfg4q = EngineConfig(input_width=IN_W, input_height=IN_H,
                         output_width=OUT_W, output_height=OUT_H, **Q4)
    step_q = make_interp_step(cfg4q, wire="i32", device=dev)

    def mv_4q(prev, curr):
        return interp_planar(frames_to_planar(prev), frames_to_planar(curr),
                             mode="pyramid", factors=[0.5],
                             dt=torch.bfloat16, block_size=8,
                             search_radius=RADIUS, return_mv=True, **Q4)[1]

    for i in range(2):
        prev, curr = frames[i], frames[i + 1]
        mvs = [in_scope(scope, mv_4q, prev, curr)
               for scope in paths.values()]
        check(bits_equal(mvs[0], mvs[1]), f"config 4q pair {i}: MV fields "
              "differ")
        outs_k, outs_p = (in_scope(scope, step_q, prev, curr)
                          for scope in paths.values())
        for ok_, op_ in zip(outs_k, outs_p):
            check(tuple(ok_.shape) == (OUT_H, OUT_W), "config 4q: output "
                  "shape")
            mx, nd, nb = byte_diff(ok_, op_)
            check(mx <= 1, f"config 4q pair {i}: kernel vs plain output "
                  f"bytes {mx}")
        print(f"phase 4: config 4q pair {i}: MV bitwise equal (sub-pel, "
              f"interior mean {mvs[0][:, 2:-3, 2:-2].mean((1, 2)).tolist()} "
              f"px), outputs within 1 code (last {nd} of {nb} bytes differ)")
    # the known answer: a (3, 1) px/frame pan, whose in-between frame is the
    # source at the half offset (1.5, 0.5): the bilinear mean of the source
    # moved by (1, 0), (2, 0), (1, 1) and (2, 1) (the synthetic texture is
    # one per seed, so these are frame 1 of pans at those velocities)
    frac = [torch.from_numpy(f).to(dev)
            for f in pan_frames(2, velocity=(3.0, 1.0))]
    moved = [frames_to_planar(torch.from_numpy(
        pan_frames(2, velocity=v)[1]).to(dev))
        for v in ((1.0, 0.0), (2.0, 0.0), (1.0, 1.0), (2.0, 1.0))]
    ref_mid = 0.25 * (moved[0] + moved[1] + moved[2] + moved[3])
    inner = (slice(None), slice(32, IN_H - 32), slice(32, IN_W - 32))

    def mid_psnr(opts):
        mid = interp_planar(frames_to_planar(frac[0]),
                            frames_to_planar(frac[1]), mode="pyramid",
                            factors=[0.5], dt=torch.bfloat16, block_size=8,
                            search_radius=RADIUS, **opts)[0]
        e = float(((mid - ref_mid)[inner] ** 2).mean())
        return 10 * np.log10(1.0 / e) if e > 0 else float("inf")

    psnr_4q, psnr_4 = mid_psnr(Q4), mid_psnr({})
    print(f"phase 4: config 4q known answer, (3, 1) px/frame pan: in-between "
          f"frame vs the source at the half offset {psnr_4q:.2f} dB (config "
          f"4: {psnr_4:.2f} dB)")
    check(psnr_4q > psnr_4, "config 4q: the in-between frame of a "
          "fractional pan is not closer to the half-shifted source than "
          "config 4's")

    # config 5: the learned head at 4K, kernel path vs plain path
    frames5 = [torch.from_numpy(f).to(dev)
               for f in pan_frames(3, w=OUT_W, h=OUT_H)]
    cfg5 = EngineConfig(input_width=OUT_W, input_height=OUT_H,
                        output_width=OUT_W, output_height=OUT_H,
                        motion_mode="learned")
    step5 = make_interp_step(cfg5, wire="i32", device=dev,
                             model_params=head, q_feed=True)
    q_init5 = make_q_init(cfg5, head, dev)
    seeds5 = {path: in_scope(scope, q_init5, frames5[0])
              for path, scope in paths.items()}

    def trunk5(pl_):
        return rife.trunk_fast(head, *(rife.frame_cache(head, x)
                                       for x in pl_))

    for i in range(2):
        prev, curr = frames5[i], frames5[i + 1]
        pl_ = [frames_to_planar(f) for f in (prev, curr)]
        trunk = {path: in_scope(scope, trunk5, pl_)
                 for path, scope in paths.items()}
        t_d = float((trunk["kernel"] - trunk["plain"]).abs().max())
        t_ref = float(trunk["plain"].abs().max())
        flow_d = float((trunk["kernel"][:4] - trunk["plain"][:4]).abs().max())
        outs = {}
        for path, scope in paths.items():
            *outs[path], seeds5[path] = in_scope(scope, step5, prev, curr,
                                                 seeds5[path])
        mid_k = outs["kernel"][0]
        check(tuple(mid_k.shape) == (OUT_H, OUT_W), "config 5: output shape")
        check(torch.equal(outs["kernel"][1], curr), "config 5: curr passes "
              "through")
        mx, nd, nb = byte_diff(mid_k, outs["plain"][0])
        over1 = int(((mid_k.view(torch.uint8).to(torch.int16)
                      - outs["plain"][0].view(torch.uint8).to(torch.int16))
                     .abs() > 1).sum())
        mid = frames_to_planar(mid_k)
        check(bool(torch.isfinite(trunk["kernel"]).all()),
              "config 5: head output not finite")
        # the midpoint of the (4, 2) pan against prev shifted by (2, 1),
        # and the crossfade's score, for information (no known-answer gate:
        # the score measures the head's training, not the port)
        ref = frames_to_planar(prev)[:, 1:, 2:]
        cross = 0.5 * (frames_to_planar(prev) + frames_to_planar(curr))

        def psnr(x):
            e = float(((x[:, :-1, :-2] - ref)[:, 32:-32, 32:-32] ** 2).mean())
            return 10 * np.log10(1.0 / e) if e > 0 else float("inf")

        print(f"phase 4: config 5 pair {i}: head output kernel vs plain max "
              f"|d| {t_d:.4e} (flows {flow_d:.4e} quarter-res px; max |ref| "
              f"{t_ref:.4f}); output bytes max |d| {mx}, {nd} of {nb} "
              f"differ (within 1 code: {1 - over1 / nb:.6f}); "
              f"midpoint vs half-shifted source {psnr(mid):.2f} dB, "
              f"crossfade {psnr(cross):.2f} dB")
        check(t_d <= C5_TRUNK_MAX_REL * t_ref,
              f"config 5 pair {i}: head output kernel vs plain")
        check(mx <= 1 and nd <= C5_BYTES_MAX_FRAC * nb,
              f"config 5 pair {i}: output bytes kernel vs plain")
    # the stream cache: the pair seeded with the last step's cache equals
    # the same pair computing prev's cache itself
    step_nq = make_interp_step(cfg5, wire="i32", device=dev,
                               model_params=head)
    q1 = make_q_init(cfg5, head, dev)(frames5[0])
    *_, q1 = step5(frames5[0], frames5[1], q1)
    *fed, _ = step5(frames5[1], frames5[2], q1)
    unfed = step_nq(frames5[1], frames5[2])
    check(all(torch.equal(a, b) for a, b in zip(fed, unfed)),
          "config 5: the stream cache changed the output")
    print("phase 4: config 5 stream cache bitwise (seeded pair == pair "
          "computing its own cache)")
    config6_phase(tag)
    c7 = config7_phase(tag)

    # the temporal seed: config 4 at x4 with the scene cut over the pan
    # that accelerates to 40 px/frame.  The kernel path is the step; the
    # plain path is interp_planar in plain_versions() (the same MV field, no
    # Lanczos); each threads its own seed, and the fields stay bitwise
    cfg_t = EngineConfig(input_width=IN_W, input_height=IN_H,
                         output_width=OUT_W, output_height=OUT_H,
                         fps_multiplier=4, temporal_mv=True,
                         scene_cut_threshold=CUT)
    step_t = make_interp_step(cfg_t, wire="i32", device=dev)
    track = [torch.from_numpy(f).to(dev)
             for f in track_frames(IN_H, IN_W, TRACK_VELOCITY)]
    seed_k = torch.zeros(mv_lattice_shape(cfg_t), device=dev)
    seed_p = seed_k.clone()
    hits = []
    for i, v in enumerate(TRACK_VELOCITY):
        *outs, seed_k = step_t(track[i], track[i + 1], seed_k)
        with plain_versions():
            _, seed_p = interp_planar(
                frames_to_planar(track[i]), frames_to_planar(track[i + 1]),
                mode="pyramid", factors=[0.5], dt=torch.bfloat16,
                block_size=8, search_radius=RADIUS, scene_cut_threshold=CUT,
                mv_seed=seed_p, return_mv=True)
        check(bits_equal(seed_k, seed_p), f"temporal pair {i}: MV fields "
              "differ between the kernel and plain paths")
        check(len(outs) == 4 and all(tuple(o.shape) == (OUT_H, OUT_W)
                                     for o in outs),
              f"temporal pair {i}: outputs")
        unseeded = interp_planar(
            frames_to_planar(track[i]), frames_to_planar(track[i + 1]),
            mode="pyramid", factors=[0.5], dt=torch.bfloat16, block_size=8,
            search_radius=RADIUS, return_mv=True)[1]
        hits.append((track_hit(seed_k, v), track_hit(unseeded, v)))
        print(f"phase 4: temporal pair {i}, pan {v} px/frame: MV bitwise "
              f"kernel vs plain; hit rate seeded {hits[-1][0]:.4f}, "
              f"unseeded {hits[-1][1]:.4f}; seed interior median "
              f"{float(seed_k[0, 1:-1, 1:-4].median()):.3f} px")
    check(min(h for h, _ in hits[3:]) >= SEEDED_HIT_MIN,
          "temporal: the seeded step lost the 40 px/frame pan")
    check(max(u for (_, u), v in zip(hits, TRACK_VELOCITY) if v == 40)
          <= UNSEEDED_HIT_MAX, "temporal: the unseeded pyramid tracked 40 "
          "px/frame (the known answer is wrong)")

    # a scene cut at x4: the pan's last frame, then uniform noise
    from tpufg_torch.io.sources import SyntheticSource
    noise = torch.from_numpy(next(iter(SyntheticSource(
        IN_W, IN_H, n_frames=1, pattern="noise", seed=1))).view(
            np.int32).reshape(IN_H, IN_W)).to(dev)
    *outs, seed_cut = step_t(track[-1], noise, seed_k)
    scaled = [lanczos_scale_packed(frames_to_planar(f), OUT_H, OUT_W,
                                   raw_i32=True) for f in (track[-1], noise)]
    check(torch.equal(outs[0], scaled[0]), "scene cut: t = 0.25 is not "
          "prev's scaled frame")
    check(all(torch.equal(o, scaled[1]) for o in outs[1:]),
          "scene cut: t = 0.5, 0.75 or curr is not curr's scaled frame")
    check(not bool(seed_cut.abs().max()), "scene cut: the next seed is not "
          "zeros")
    print("phase 4: scene cut at x4: t = 0.25 == prev's scaled frame, t = "
          "0.5 and 0.75 == curr's, byte for byte; the next seed all zeros")

    # config 4 at x4: the three in-between frames, kernel path vs plain
    cfg_x4 = EngineConfig(input_width=IN_W, input_height=IN_H,
                          output_width=OUT_W, output_height=OUT_H,
                          fps_multiplier=4)
    step_x4 = make_interp_step(cfg_x4, wire="i32", device=dev)
    for i in range(2):
        outs_k, outs_p = (in_scope(scope, step_x4, frames[i], frames[i + 1])
                          for scope in paths.values())
        check(len(outs_k) == len(outs_p) == 4, "config 4 x4: outputs")
        diffs = [byte_diff(a, b) for a, b in zip(outs_k, outs_p)]
        check(max(d[0] for d in diffs) <= 1, f"config 4 x4 pair {i}: kernel "
              "vs plain bytes")
        check(len({o.cpu().numpy().tobytes() for o in outs_k[:3]}) == 3,
              "config 4 x4: the in-between frames are not distinct")
        print(f"phase 4: config 4 x4 pair {i}: t = 0.25, 0.5, 0.75 and curr "
              f"within 1 code kernel vs plain (bytes differing "
              f"{[d[1] for d in diffs]} of {diffs[0][2]})")

    # the exact step: its kernel path against its plain path (the plain
    # versions of its three kernels) on 3 pairs of the (4, 2) pan at a
    # quarter of 1080p, b8 r16: bytes bitwise, the MV field bitwise to the
    # oracle's search; the plain step's time a pair is the exact path's
    # yardstick.  The known answer: the exact MV is the pan's
    # (negated for the warp) in the interior, and the midpoint's UNORM8
    # bytes are prev's moved by (2, 1) there
    cfg_ex = EngineConfig(input_width=EX_W, input_height=EX_H,
                          output_width=2 * EX_W, output_height=2 * EX_H)
    step_ex = make_interp_step(cfg_ex, "exact", device=dev)
    ex_frames = [torch.from_numpy(f.view(np.uint8).reshape(EX_H, EX_W, 4))
                 .to(dev) for f in pan_frames(EX_PAIRS + 1, w=EX_W, h=EX_H)]
    plain_ex_s = []
    inner_ex = (slice(24, EX_H - 24), slice(24, EX_W - 24))
    for i in range(EX_PAIRS):
        prev, curr = ex_frames[i], ex_frames[i + 1]
        outs_k = step_ex(prev, curr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_p = in_scope(plain_versions, step_ex, prev, curr)
        torch.cuda.synchronize()
        plain_ex_s.append(time.perf_counter() - t0)
        check(all(torch.equal(a, b) for a, b in zip(outs_k, outs_p)),
              f"exact pair {i}: kernel vs plain bytes")
        p_, c_ = oracle.dequantize_unorm8(prev), oracle.dequantize_unorm8(curr)
        mv_k = pipeline.exact_mv(p_, c_, 8, RADIUS)
        check(bits_equal(mv_k, -oracle.motion_search(p_, c_, 8, RADIUS)),
              f"exact pair {i}: MV field differs from the oracle's")
        m = mv_k[inner_ex]
        hit = float(((m[..., 0] == -4) & (m[..., 1] == -2)).float().mean())
        mid = oracle.quantize_unorm8(oracle_warp(p_, c_, mv_k, 0.5))
        same = float((mid[:-1, :-2][inner_ex] == prev[1:, 2:][inner_ex])
                     .all(-1).float().mean())
        print(f"phase 4: exact pair {i} [{EX_H},{EX_W}] -> "
              f"[{2 * EX_H},{2 * EX_W}] b8 r{RADIUS}: bytes bitwise kernel "
              f"vs plain, MV field bitwise to the oracle's search; pan MV "
              f"hit rate {hit:.4f}, midpoint "
              f"bytes == prev moved by (2, 1) on {same:.4f} of the interior; "
              f"plain step {plain_ex_s[-1]:.3f} s {tag}")
        check(hit >= EXACT_HIT_MIN, "exact: pan MV not recovered")
        check(same >= EXACT_HIT_MIN, "exact: midpoint does not match the "
              "half-shifted source")
    # the BASELINE bf16 gate on the card: fast bf16 against fast f32 at
    # 1080p -> 4K (and the fidelity to the exact oracle, reported)
    log_out = io.StringIO()
    with contextlib.redirect_stdout(log_out):
        rc = validate.main([f"synthetic:{IN_W}x{IN_H}", "--output-width",
                            str(OUT_W), "--output-height", str(OUT_H),
                            "--frames", "2"])
    lines = [ln.split("] ", 2)[-1] for ln in log_out.getvalue().splitlines()]
    prec = [ln for ln in lines if "precision SSIM (vs f32 path) mean" in ln]
    check(rc == 0 and len(prec) == 1, f"validate: exit code {rc}, log "
          f"{lines!r}")
    ssim_mean = float(prec[0].split("mean ")[1].split()[0])
    check(ssim_mean >= 0.999, f"validate: precision SSIM {ssim_mean}")
    for ln in lines:
        print(f"phase 4: validate 1080p -> 4K, 2 pairs: {ln} {tag}")

    # synchronisations: the temporal x4 cut step with the y4m egress
    # against config 4's step, under the sync debug mode (its warnings
    # that a call synchronised)
    import warnings

    def sync_warnings(step, n=3):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n):
                    step(frames[0], frames[1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # (the mode's own notice, "a prototype feature", is not one)
        return sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in seen)

    cfg_ty = EngineConfig(input_width=IN_W, input_height=IN_H,
                          output_width=OUT_W, output_height=OUT_H,
                          fps_multiplier=4, temporal_mv=True,
                          scene_cut_threshold=CUT)
    step_ty = Seeded(make_interp_step(cfg_ty, wire="i32", sink_wire="y4m420",
                                      device=dev), mv_lattice_shape(cfg_ty),
                     dev)
    step_c4 = make_interp_step(cfgs["config 4"][0], wire="i32", device=dev)
    for step in (step_c4, step_ty):              # warm-up: first-use caches
        step(frames[0], frames[1])
    n_sync = {"config 4": sync_warnings(step_c4),
              "config 4 x4 temporal cut y4m": sync_warnings(step_ty),
              # a control: a host read of a device value is counted
              "control, .item()": sync_warnings(
                  lambda p_, c_: frames_to_planar(p_)[0, 0, 0].item())}
    print(f"phase 4: synchronising calls in 3 steps (sync debug warnings): "
          f"{n_sync}")
    check(n_sync["control, .item()"] >= 3, "the sync debug mode did not "
          "count a host read")
    check(n_sync["config 4 x4 temporal cut y4m"] <= n_sync["config 4"],
          "the temporal x4 cut y4m step synchronises more than config 4's")

    # ---- phase 5: timing
    step_p50 = {}
    for name, (cfg, _) in cfgs.items():
        step = make_interp_step(cfg, wire="i32", device=dev)
        p50, p99, fps = step_times(step, frames)
        step_p50[name] = p50
        enq = host_enqueue_ms(step, frames)
        print(f"phase 5: {name} step over 50 pairs: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms per pair, steady {fps:.1f} output fps; host "
              f"enqueue {enq:.3f} ms per pair {tag}")
    p50, p99, fps = step_times(step_q, frames)
    enq = host_enqueue_ms(step_q, frames)
    print(f"phase 5: config 4q step over 50 pairs: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms per pair, steady {fps:.1f} output fps; host "
          f"enqueue {enq:.3f} ms per pair {tag}")
    # config 3 at --block-size 16: the tiled search carries the step
    cfg3b = EngineConfig(input_width=IN_W, input_height=IN_H,
                         output_width=IN_W, output_height=IN_H,
                         motion_mode="exhaustive", block_size=16)
    p50, p99, fps = step_times(make_interp_step(cfg3b, wire="i32",
                                                device=dev), frames, n=20,
                               warmup=3)
    print(f"phase 5: config 3 at block size 16 step over 20 pairs: p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms per pair, steady {fps:.1f} output "
          f"fps {tag}")
    # config 5: the engine's step (curr encoded, prev's cache given)
    q5 = make_q_init(cfg5, head, dev)(frames5[0])
    p50, p99, fps = step_times(lambda p_, c_: step5(p_, c_, q5), frames5)
    enq = host_enqueue_ms(lambda p_, c_: step5(p_, c_, q5), frames5)
    print(f"phase 5: config 5 step over 50 pairs: p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms per pair, steady {fps:.1f} output fps; host "
          f"enqueue {enq:.3f} ms per pair {tag}")
    # the engine's options on config 4, and config 5a: the pyramid at 4K
    # identity size (tools/bench_matrix.py's row 5a); profiled at the end
    # of the phase, after the kernels' own profiles
    profiled = []
    cfg_5a = EngineConfig(input_width=OUT_W, input_height=OUT_H,
                          output_width=OUT_W, output_height=OUT_H)
    cfg_tm = EngineConfig(input_width=IN_W, input_height=IN_H,
                          output_width=OUT_W, output_height=OUT_H,
                          temporal_mv=True)
    for name, make, fr, k_out in (
            ("config 4", lambda: make_interp_step(cfgs["config 4"][0],
                                                  wire="i32", device=dev),
             frames, 2),
            ("config 4 x4", lambda: step_x4, frames, 4),
            ("config 4 --temporal-mv",
             lambda: Seeded(make_interp_step(cfg_tm, wire="i32", device=dev),
                            mv_lattice_shape(cfg_tm), dev), frames, 2),
            ("config 4 y4m420 egress",
             lambda: make_interp_step(cfgs["config 4"][0], wire="i32",
                                      sink_wire="y4m420", device=dev),
             frames, 2),
            ("config 4 x4 temporal cut y4m420", lambda: step_ty, frames, 4),
            ("config 5a", lambda: make_interp_step(cfg_5a, wire="i32",
                                                   device=dev), frames5, 2)):
        step = make()
        p50, p99, fps = step_times(step, fr, outs_per_pair=k_out)
        enq = host_enqueue_ms(step, fr)
        print(f"phase 5: {name} step over 50 pairs: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms per pair, steady {fps:.1f} output fps; host "
              f"enqueue {enq:.3f} ms per pair {tag}")
        profiled.append((name, step, fr, k_out * 1e3 / fps))

    # the steps' stages, each bracketed by events and synchronised
    stages = {}

    def stage(label, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        stages[label] = stages.get(label, 0.0) + a.elapsed_time(b)
        return out

    n_st = 20
    hp, wp = 1088, IN_W

    # config 4's stages: the pyramid of tpufg_torch/models/pyramid.py at the
    # engine's settings (3 levels, r = 4 then 2, the finest refine skipped),
    # the integer-offset blend warp, Lanczos on the in-between frame and curr
    def up2(mv):
        return mv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0

    step4 = make_interp_step(cfgs["config 4"][0], wire="i32", device=dev)
    for j in range(n_st + 3):
        if j == 3:
            stages.clear()   # three warm-up pairs
        prev, curr = frames[j % 2], frames[j % 2 + 1]
        pl = stage("unpack x2 (CUDA kernel)",
                   lambda: (frames_to_planar(prev), frames_to_planar(curr)))
        pp, cp = stage("edge pad x2, 1080->1088 rows (plain torch)",
                       lambda: tuple(pipeline._edge_pad_chw(x, hp, wp)
                                     for x in pl))
        l1 = stage("box2 x4 (CUDA kernel)",
                   lambda: (box_downsample2(pp), box_downsample2(cp)))
        l2 = stage("box2 x4 (CUDA kernel)",
                   lambda: (box_downsample2(l1[0]), box_downsample2(l1[1])))
        mv2 = stage("lattice search r=4 at 1/4 (plain torch)",
                    lambda: motion_search_lattice(*l2, search_radius=4))
        mv1 = stage("MV upsamples x2 (plain torch)", lambda: up2(mv2))
        wa = stage("refine warp at 1/2, integer offsets (CUDA kernel)",
                   lambda: warp_blend_matmul(l1[0], l1[0], mv1,
                                             search_radius=10, single=True,
                                             integer_offsets=True))
        mv1 = stage("lattice search r=2 at 1/2 + add (plain torch)",
                    lambda: mv1 + motion_search_lattice(wa, l1[1],
                                                        search_radius=2))
        mv = stage("MV upsamples x2 (plain torch)", lambda: up2(mv1))
        mid = stage("blend warp, integer offsets, cropped (CUDA kernel)",
                    lambda: warp_blend_matmul(
                        pp, cp, -mv, factor=0.5, search_radius=RADIUS,
                        dtype=torch.bfloat16, integer_offsets=True,
                        u8_exact=True, crop=(IN_H, IN_W)))
        outs = stage("Lanczos x2 to 4K (CUDA kernel)",
                     lambda: tuple(lanczos_scale_packed(
                         x, OUT_H, OUT_W, raw_i32=True) for x in (mid, pl[1])))
        if j == 0:
            check(all(torch.equal(a_, b_) for a_, b_ in
                      zip(outs, step4(prev, curr))),
                  "config 4: the staged pipeline is not the step's")
    for label, ms in stages.items():
        print(f"phase 5: config 4 stage {label}: {ms / n_st:.4f} ms per pair "
              f"{tag}")
    print(f"phase 5: config 4 sum of synchronised stages "
          f"{sum(stages.values()) / n_st:.4f} ms per pair {tag}")

    # config 4q's stages: config 4's with the lattice searches' bias, then
    # the sub-pel refine, the median, the 8-px resize, the per-pixel warp's
    # pair and the epilogue
    stages.clear()
    for j in range(n_st + 3):
        if j == 3:
            stages.clear()
        prev, curr = frames[j % 2], frames[j % 2 + 1]
        pl = stage("unpack x2 (CUDA kernel)",
                   lambda: (frames_to_planar(prev), frames_to_planar(curr)))
        pp, cp = stage("edge pad x2, 1080->1088 rows (plain torch)",
                       lambda: tuple(pipeline._edge_pad_chw(x, hp, wp)
                                     for x in pl))
        l1 = stage("box2 x4 (CUDA kernel)",
                   lambda: (box_downsample2(pp), box_downsample2(cp)))
        l2 = stage("box2 x4 (CUDA kernel)",
                   lambda: (box_downsample2(l1[0]), box_downsample2(l1[1])))
        mv2 = stage("lattice search r=4 at 1/4, bias 0.1 (plain torch)",
                    lambda: motion_search_lattice(*l2, search_radius=4,
                                                  bias=0.1))
        mv1 = stage("MV upsamples x2 (plain torch)", lambda: up2(mv2))
        wa = stage("refine warp at 1/2, integer offsets (CUDA kernel)",
                   lambda: warp_blend_matmul(l1[0], l1[0], mv1,
                                             search_radius=10, single=True,
                                             integer_offsets=True))
        mv1 = stage("lattice search r=2 at 1/2, bias 0.1 + add (plain torch)",
                    lambda: mv1 + motion_search_lattice(
                        wa, l1[1], search_radius=2, bias=0.1))
        mv = stage("MV upsamples x2 (plain torch)", lambda: up2(mv1))
        mv = stage("sub-pel refine, 2 rounds (plain torch, each with a "
                   "fractional probe warp: CUDA kernel)",
                   lambda: subpel_refine(pp, cp, mv, search_radius=RADIUS,
                                         bias=0.1, dtype=torch.bfloat16))
        mv = stage("3x3 median (plain torch)", lambda: median_filter_mv(mv))
        mv8 = stage("resize to the 8-px lattice (plain torch)",
                    lambda: resize_linear(mv, (2, 2 * mv.shape[1],
                                               2 * mv.shape[2]),
                                          sum_axes=(1,)))
        pair, cells = stage(
            "per-pixel warp, pair mode and the fallback's cell means "
            "(warp_obmc kernel, its offsets made in the kernel)",
            lambda: warp_obmc(pp, cp, -mv8, block=8, search_radius=RADIUS,
                              dtype=torch.bfloat16, pair=True, cells=True))
        mid = stage("occlusion + fallback, cropped (warp_epilogue kernel)",
                    lambda: warp_epilogue(pair, pp, cp, 0.5, True, True,
                                          crop=(IN_H, IN_W), cells=cells))
        outs = stage("Lanczos x2 to 4K (CUDA kernel)",
                     lambda: tuple(lanczos_scale_packed(
                         x, OUT_H, OUT_W, raw_i32=True) for x in (mid, pl[1])))
        if j == 0:
            check(all(torch.equal(a_, b_) for a_, b_ in
                      zip(outs, step_q(prev, curr))),
                  "config 4q: the staged pipeline is not the step's")
    for label, ms in stages.items():
        print(f"phase 5: config 4q stage {label}: {ms / n_st:.4f} ms per "
              f"pair {tag}")
    print(f"phase 5: config 4q sum of synchronised stages "
          f"{sum(stages.values()) / n_st:.4f} ms per pair {tag}")

    # config 3's stages, the same way
    stages.clear()
    for j in range(n_st + 3):
        if j == 3:
            stages.clear()
        prev, curr = frames[j % 2], frames[j % 2 + 1]
        pl = stage("unpack x2 (CUDA kernel)",
                   lambda: (frames_to_planar(prev), frames_to_planar(curr)))
        pp, cp = stage("edge pad x2, 1080->1088 rows (plain torch)",
                       lambda: tuple(pipeline._edge_pad_chw(x, hp, wp)
                                     for x in pl))
        mv = stage(f"sites search r={RADIUS} + subsample (CUDA kernel)",
                   lambda: motion_search_sites(
                       pp, cp, search_radius=RADIUS,
                       tile_w=sites_tile_w(RADIUS), dx_chunk=3)[:, :, 8::16])
        mid = stage("fractional warp + blend, cropped to 1080x1920 (CUDA "
                    "kernel)",
                    lambda: warp_blend_matmul(
                        pp, cp, -mv, factor=0.5, search_radius=RADIUS,
                        dtype=torch.bfloat16, u8_exact=True,
                        crop=(IN_H, IN_W)))
        stage("pack to the i32 wire (plain torch)",
              lambda: planar_to_i32(mid))
    for label, ms in stages.items():
        print(f"phase 5: config 3 stage {label}: {ms / n_st:.4f} ms per pair "
              f"{tag}")
    print(f"phase 5: config 3 sum of synchronised stages "
          f"{sum(stages.values()) / n_st:.4f} ms per pair {tag}")

    # config 5's stages, the same way
    stages.clear()
    for j in range(n_st + 3):
        if j == 3:
            stages.clear()
        prev, curr = frames5[j % 2], frames5[j % 2 + 1]
        pl = stage("unpack x2 (CUDA kernel)",
                   lambda: (frames_to_planar(prev), frames_to_planar(curr)))
        c4, f4c = stage("encode curr: quarter frame + enc1 (conv3x3_s2 "
                        "kernel) + enc2",
                        lambda: rife.frame_cache(head, pl[1]))
        p4, f4p = q5
        out0_4 = stage("stage 1 at 1/8 (enc3, c_body, c_head) + 2x upsample",
                       lambda: rife._up2(rife._stage1(head, f4p, f4c)))
        p4w, c4w = stage("coarse warp x2, 8-px blocks (CUDA kernel)",
                         lambda: rife._coarse_warp8(out0_4, p4, c4))
        out = stage("stage 2 (conv3x3_chain kernel) + residual",
                    lambda: out0_4 + rife._stage2(head, p4w, c4w, out0_4))
        mid = stage("tail: lattice flow, mask upsample, fuse (plain torch), "
                    "2 fractional warps (CUDA kernel)",
                    lambda: rife.tails_fast(head, out, *pl, [0.5])[0])
        stage("pack to the i32 wire (plain torch)",
              lambda: planar_to_i32(mid))
    for label, ms in stages.items():
        print(f"phase 5: config 5 stage {label}: {ms / n_st:.4f} ms per pair "
              f"{tag}")
    print(f"phase 5: config 5 sum of synchronised stages "
          f"{sum(stages.values()) / n_st:.4f} ms per pair {tag}")
    # the --trace run's step spans (phase 3, 20 frames) beside config 4's
    # CUDA-event p50 (the profiler drops records: the count is printed)
    print(f"phase 5: config 4 step: --trace's tpufg.step device p50 "
          f"{np.percentile(trace_steps, 50):.4f} ms over {len(trace_steps)} "
          f"of {TRACE_FRAMES} spans; CUDA events p50 "
          f"{step_p50['config 4']:.4f} ms {tag}")

    # the exact step 1080p -> 4K on the (4, 2) pan: the oracle's spec, not
    # a real-time path (recorded, not gated), and its stages
    cfg_exact = EngineConfig(input_width=IN_W, input_height=IN_H,
                             output_width=OUT_W, output_height=OUT_H)
    step_exact = make_interp_step(cfg_exact, "exact", device=dev)
    frames_u8 = [f.view(torch.uint8).reshape(IN_H, IN_W, 4) for f in frames]
    p50, p99, fps = step_times(step_exact, frames_u8, n=10, warmup=2)
    print(f"phase 5: exact step 1080p -> 4K over 10 pairs: p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms per pair, steady {fps:.1f} output fps {tag}")
    stages.clear()
    n_ex = 5
    for j in range(n_ex + 2):
        if j == 2:
            stages.clear()   # two warm-up pairs
        prev, curr = frames_u8[j % 2], frames_u8[j % 2 + 1]
        p_, c_ = stage("UNORM8 read x2 (plain torch)",
                       lambda: (oracle.dequantize_unorm8(prev),
                                oracle.dequantize_unorm8(curr)))
        mv = stage(f"per-pixel search b8 r{RADIUS}, exact box, with the "
                   "planar copies and the negation (CUDA kernel)",
                   lambda: pipeline.exact_mv(p_, c_, 8, RADIUS))
        mid = stage("warp + blend t=0.5 (CUDA kernel)",
                    lambda: oracle_warp(p_, c_, mv, 0.5))
        outs = stage("scale + UNORM8 store x2 to 4K (CUDA kernel)",
                     lambda: (oracle_scale(mid, OUT_H, OUT_W),
                              oracle_scale(c_, OUT_H, OUT_W)))
        if j == 0:
            check(all(torch.equal(a_, b_) for a_, b_ in
                      zip(outs, step_exact(prev, curr))),
                  "exact: the staged pipeline is not the step's")
    for label, ms in stages.items():
        print(f"phase 5: exact stage {label}: {ms / n_ex:.4f} ms per pair "
              f"{tag}")
    print(f"phase 5: exact sum of synchronised stages "
          f"{sum(stages.values()) / n_ex:.4f} ms per pair; the plain step "
          f"at [{EX_H},{EX_W}] -> [{2 * EX_H},{2 * EX_W}] (phase 4) "
          f"{np.median(plain_ex_s) * 1e3:.1f} ms per pair {tag}")

    timings = {}
    timings["unpack"] = time_pair(lambda: frames_to_planar(wire),
                                  lambda: frames_to_planar_plain(wire))
    for shape, x in box_in.items():
        timings[f"box2 {list(shape)}"] = time_pair(
            lambda x=x: box_downsample2(x),
            lambda x=x: box_downsample2_plain(x))
    for (ih, iw, oh, ow, a), x in scale_in.items():
        timings[f"lanczos {ih}x{iw}->{oh}x{ow} a={a}"] = time_pair(
            lambda x=x, oh=oh, ow=ow, a=a: lanczos_scale_packed(
                x, oh, ow, a, raw_i32=True),
            lambda x=x, oh=oh, ow=ow, a=a: lanczos_scale_packed_plain(
                x, oh, ow, a, raw_i32=True), n_plain=20)
    # the plain searches take ~1 s per call at 1080p: fewer repetitions
    for key, (pr, cu) in motion_in.items():
        if key[0] == "sites":
            label = f"sites {list(key[1:])} r={RADIUS}"
            timings[label] = time_pair(
                lambda pr=pr, cu=cu: motion_search_sites(
                    pr, cu, search_radius=RADIUS, dx_chunk=3),
                lambda pr=pr, cu=cu: motion_search_sites_plain(
                    pr, cu, search_radius=RADIUS), n=10, n_plain=2)
        else:
            _, b, r, exact = key[:4]
            label = f"tiled {list(key[4:])} b={b} r={r} exact_box={exact}"
            timings[label] = time_pair(
                lambda pr=pr, cu=cu, b=b, r=r, exact=exact:
                    motion_search_tiled(pr, cu, block_size=b,
                                        search_radius=r, exact_box=exact),
                lambda pr=pr, cu=cu, b=b, r=r, exact=exact:
                    motion_search_tiled_plain(pr, cu, b, r, exact_box=exact),
                n=3, n_plain=2)
    for (_, _, dt), (x, w_, b_) in ((k_, v_) for k_, v_ in conv_in.items()
                                    if k_ != "chain"):
        timings[f"conv3x3_s2 {list(x.shape)} {dt}"] = time_pair(
            lambda x=x, w_=w_, b_=b_, dt=dt: conv3x3_s2(
                x, w_, b_, compute_dtype=dt),
            lambda x=x, w_=w_, b_=b_, dt=dt: conv3x3_s2_plain(
                x, w_, b_, compute_dtype=dt))
    # the chain's weights were packed by its phase-2 calls: the timed calls
    # find them in the wrapper's cache and launch the kernel only
    x = conv_in["chain"]
    for label, xin, cw in (("[17, 540, 960]", x, chain_w),
                           ("[13, 540, 960]", x13, chain_w13)):
        timings[f"conv3x3_chain {label} bf16, weights already packed"] = \
            time_pair(lambda xin=xin, cw=cw: conv3x3_chain(xin, cw, chain_b),
                      lambda xin=xin, cw=cw: conv3x3_chain_plain(xin, cw,
                                                                 chain_b),
                      n=50, n_plain=20)
    for (c, ih, iw, oh, ow, dt), x in fast_in.items():
        timings[f"lanczos_fast [{c},{ih},{iw}]->{oh}x{ow} {dt}"] = time_pair(
            lambda x=x, oh=oh, ow=ow: lanczos_scale_fast(x, oh, ow),
            lambda x=x, oh=oh, ow=ow: lanczos_scale_fast_plain(x, oh, ow))
    # the warps also on the device alone (graph_ms, operands cycled past
    # the L2): at the engine's smaller shapes the wrapper's host cost per
    # call exceeds the kernel's; the rows keep the call's time as ``ms``
    warp_calls = {}
    for label, kw in BLOCK_WARP_MODES.items():
        warp_calls[f"warp_block [4,{API_H},{IN_W}] {label}"] = (
            lambda a, b, mv, kw=kw: warp_blend_block(
                a, b, mv, search_radius=RADIUS, **kw),
            lambda kw=kw: warp_blend_block_plain(wp_prev, wp_curr, wp_mv,
                                                 search_radius=RADIUS, **kw),
            50, (wp_prev, wp_curr, wp_mv),
            (2 if kw.get("single") else 3) * wp_prev.nbytes + wp_mv.nbytes)
    for label, (a, b, mv, kw, crop) in engine_in.items():
        out_n = a.shape[0] * (crop[0] * crop[1] if crop else a[0].numel())
        warp_calls[f"warp_matmul {label}"] = (
            lambda a, b, mv, kw=kw, crop=crop: warp_blend_matmul(
                a, b, mv, crop=crop, **kw),
            lambda a=a, b=b, mv=mv, kw=kw, crop=crop: warp_blend_matmul_plain(
                a, b, mv, crop=crop, **kw), 10, (a, b, mv),
            (1 if kw.get("single") else 2) * a.nbytes + mv.nbytes + out_n * 4)
    # config 4q's, as its path runs them: the per-pixel warp's pair and
    # cell means (frames and MVs in, the pair and the means out) and the
    # epilogue with both options (the pair, the means and the frames in,
    # the cropped frame out)
    warp_calls["warp_obmc [4,1088,1920] pair"] = (
        lambda a, b, mv: warp_obmc(a, b, mv, block=8, search_radius=RADIUS,
                                   dtype=torch.bfloat16, pair=True,
                                   cells=True),
        lambda: warp_obmc_plain(qa, qb, q_mv[8], block=8,
                                search_radius=RADIUS, dtype=torch.bfloat16,
                                pair=True, cells=True),
        5, (qa, qb, q_mv[8]),
        2 * qa.nbytes + q_mv[8].nbytes + q_pair.nbytes + q_cells.nbytes)
    warp_calls["warp_epilogue [4,1088,1920] occlusion + fallback"] = (
        lambda pr, a, b, cl: warp_epilogue(pr, a, b, 0.5, True, True,
                                           crop=q_crop, cells=cl),
        lambda: warp_epilogue_plain(q_pair, qa, qb, 0.5, True, True,
                                    crop=q_crop, cells=q_cells),
        10, (q_pair, qa, qb, q_cells), q_pair.nbytes + 2 * qa.nbytes
        + q_cells.nbytes + 4 * IN_H * IN_W * 4)
    # every other kernel at its first shape on the device alone too:
    # (function, operands, bytes a call moves, calls in the graph)
    x_box = box_in[(4, 1088, 1920)]
    x_lp = scale_in[(1080, 1920, OUT_H, OUT_W, 3)]
    x_lf = fast_in[(4, 1080, 1920, OUT_H, OUT_W, torch.float32)]
    g_s2 = conv_in[("s2", 4, torch.bfloat16)]
    graph_calls = {
        "unpack": (frames_to_planar, (wire,), 5 * wire.nbytes, 50),
        "box2 [4, 1088, 1920]": (box_downsample2, (x_box,),
                                 x_box.nbytes * 5 // 4, 50),
        "lanczos 1080x1920->2160x3840 a=3": (
            lambda x: lanczos_scale_packed(x, OUT_H, OUT_W, 3, raw_i32=True),
            (x_lp,), x_lp.nbytes + OUT_H * OUT_W * 4, 50),
        f"lanczos_fast [4,1080,1920]->{OUT_H}x{OUT_W} torch.float32": (
            lambda x: lanczos_scale_fast(x, OUT_H, OUT_W), (x_lf,),
            x_lf.nbytes + 4 * OUT_H * OUT_W * 4, 50),
        f"sites [4, 1088, 1920] r={RADIUS}": (
            lambda a, b: motion_search_sites(a, b, search_radius=RADIUS,
                                             dx_chunk=3),
            motion_in[("sites", 4, 1088, 1920)],
            2 * motion_in[("sites", 4, 1088, 1920)][0].nbytes, 10),
        f"tiled [4, 1088, 1920] b=16 r={RADIUS} exact_box=False": (
            lambda a, b: motion_search_tiled(a, b, block_size=16,
                                             search_radius=RADIUS,
                                             exact_box=False),
            motion_in[("tiled", 16, RADIUS, False, 4, 1088, 1920)],
            5 * motion_in[("tiled", 16, RADIUS, False, 4, 1088,
                           1920)][0].nbytes // 2, 5),
        "conv3x3_s2 [4, 2160, 3840] torch.bfloat16": (
            lambda x: conv3x3_s2(x, g_s2[1], g_s2[2],
                                 compute_dtype=torch.bfloat16),
            (g_s2[0],), g_s2[0].nbytes * 3, 50),
        "conv3x3_chain [17, 540, 960] bf16, weights already packed": (
            lambda x: conv3x3_chain(x, chain_w, chain_b),
            (conv_in["chain"],), conv_in["chain"].nbytes * 22 // 17, 50),
    }
    # the y4m egress at 4K, C420 (the timed row) and C444: the frame read
    # once, the payload written once
    for chroma, x in yuv_in.items():
        name = f"yuv [{OUT_H},{OUT_W}] C{chroma}"
        out_n = 3 * OUT_H * OUT_W // (2 if chroma == "420" else 1)
        timings[name] = time_pair(
            lambda x=x, chroma=chroma: rgba_to_y4m_payload(x, chroma),
            lambda x=x, chroma=chroma: rgba_to_y4m_payload_plain(x, chroma))
        graph_calls[name] = (lambda x, chroma=chroma: rgba_to_y4m_payload(
            x, chroma), (x,), x.nbytes + out_n, 50)
    # the exact path's kernels at its shapes: the scale 1080p -> 4K, the
    # warp at 1080p (t = 0.5, the MVs past every edge), the tiled search
    # with the exact box (its call timed above with the other searches)
    x_os = oracle_in[(IN_H, IN_W, OUT_H, OUT_W)]
    timings["oracle_scale 1080p->4K"] = time_pair(
        lambda: oracle_scale(x_os, OUT_H, OUT_W),
        lambda: oracle_scale_plain(x_os, OUT_H, OUT_W), n_plain=3)
    graph_calls["oracle_scale 1080p->4K"] = (
        lambda x: oracle_scale(x, OUT_H, OUT_W), (x_os,),
        x_os.nbytes + OUT_H * OUT_W * 4, 50)
    timings["oracle_warp 1080p t=0.5"] = time_pair(
        lambda: oracle_warp(ex_a, ex_b, ex_mv, 0.5),
        lambda: oracle_warp_plain(ex_a, ex_b, ex_mv, 0.5), n_plain=5)
    graph_calls["oracle_warp 1080p t=0.5"] = (
        lambda a, b, m: oracle_warp(a, b, m, 0.5), (ex_a, ex_b, ex_mv),
        3 * ex_a.nbytes + ex_mv.nbytes, 50)
    key_ex = ("tiled", 8, RADIUS, True, 4, IN_H, IN_W)
    tiled_ex_label = f"tiled [4, {IN_H}, {IN_W}] b=8 r={RADIUS} exact_box=True"
    graph_calls[tiled_ex_label] = (
        lambda a, b: motion_search_tiled(a, b, block_size=8,
                                         search_radius=RADIUS,
                                         exact_box=True),
        motion_in[key_ex], 5 * motion_in[key_ex][0].nbytes // 2, 5)
    device_ms, warp_bytes = {}, {}
    for name, (kernel_fn, plain_fn, n_plain, args, moved) in \
            warp_calls.items():
        timings[name] = time_pair(lambda f=kernel_fn, x=args: f(*x),
                                  plain_fn, n_plain=n_plain)
        warp_bytes[name] = moved
        graph_calls[name] = (kernel_fn, args, moved, 50)
    for name, (kernel_fn, args, moved, n) in graph_calls.items():
        sets = operand_sets(args, moved)
        device_ms[name] = graph_ms(kernel_fn, sets, n)
        print(f"phase 5: {name}: kernel on the device alone "
              f"{device_ms[name]:.4f} ms (a graph of {n} calls over "
              f"{len(sets)} operand sets of {moved / 2**20:.1f} MiB) {tag}")
        del sets
    for name, (km, pm) in timings.items():
        print(f"phase 5: {name}: kernel {km:.4f} ms, plain {pm:.4f} ms {tag}")

    # one PyTorch call computing the same function, where there is one:
    # box2 is a 2x2 mean; conv_s2 is cuDNN's stride-2 conv on the input
    # padded (0, 1) as XLA pads SAME, f32 with TF32 off (its operands are
    # the bf16-rounded f32 values conv3x3_s2 takes)
    x_box = box_in[(4, 1088, 1920)]
    x_s2 = F.pad(conv_in[("s2", 4, torch.bfloat16)][0].to(
        torch.bfloat16).float()[None], (0, 1, 0, 1))
    w_s2 = head["enc1"]["w"].to(torch.bfloat16).float()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        library = {
            "box2": time_ms(lambda: F.avg_pool2d(x_box, 2)),
            "conv_s2": time_ms(lambda: F.conv2d(x_s2, w_s2, head["enc1"]["b"],
                                                stride=2)),
        }
    # the single-mode warps' yardstick: grid_sample, bilinear, border
    # padding, on a per-pixel grid built beforehand from the block MVs
    def sample_grid(mv, g, h, w):
        md = mv.repeat_interleave(g, 1).repeat_interleave(g, 2)
        ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
        xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
        return torch.stack(((xs + md[0]) * (2 / (w - 1)) - 1,
                            (ys + md[1]) * (2 / (h - 1)) - 1), -1)[None]

    md_blk = torch.clamp(wp_mv, -RADIUS, RADIUS)
    a_t, _, mv_t, kw_t, _ = engine_in["config 5 tail"]
    for name, x, grid in (
            ("warp_block single", wp_prev,
             sample_grid(md_blk, 16, API_H, IN_W)),
            ("warp_matmul tail", a_t,
             sample_grid(torch.clamp(mv_t, -kw_t["search_radius"],
                                     kw_t["search_radius"]), 16,
                         *a_t.shape[1:]))):
        library[name] = time_ms(lambda x=x, grid=grid: F.grid_sample(
            x[None], grid, mode="bilinear", padding_mode="border",
            align_corners=True))
    for name, ms in library.items():
        print(f"phase 5: library call for {name}: {ms:.4f} ms {tag}")

    # the kernels one conv3x3_s2 call launches once its weights are packed
    x_p, w_, b_ = conv_in[("s2", 4, torch.bfloat16)]
    n_kernels = device_kernels(lambda: conv3x3_s2(x_p, w_, b_))
    print(f"phase 5: conv3x3_s2 with cached weights: {n_kernels} device "
          f"kernels in 5 calls (0: the profiler saw no device activity)")
    check(n_kernels in (0, 5), "conv3x3_s2 launches more than its kernel")
    # one warp_obmc call is one device kernel: its offsets are made in it
    n_kernels = device_kernels(lambda: warp_obmc(
        qa, qb, q_mv[8], block=8, search_radius=RADIUS,
        dtype=torch.bfloat16, pair=True, cells=True))
    print(f"phase 5: warp_obmc pair and cell means [4,1088,1920]: "
          f"{n_kernels} device "
          f"kernels in 5 calls (0: the profiler saw no device activity)")
    check(n_kernels in (0, 5), "warp_obmc launches more than its kernel")
    # the device's share of each option step's profiled window: activities,
    # busy time and window from the same records; the steady ms a pair of
    # the CUDA-event run above stands beside it (the profiler and its
    # markers slow the host)
    for name, step, fr, steady in profiled:
        n_act, busy, window = device_profile(step, fr, pairs=10)
        check(busy <= window + 1e-9, f"{name}: device busy {busy} ms over "
              f"a window of {window} ms")
        idle = f"{1 - busy / window:.4f}" if window else "not measured"
        print(f"phase 5: {name} profile over 10 pairs: {n_act / 10:.1f} "
              f"device activities a pair, device busy {busy / 10:.4f} ms a "
              f"pair in a window of {window / 10:.4f} ms a pair, idle share "
              f"{idle} (the CUDA-event run's steady {steady:.4f} ms a pair; "
              f"0 activities: the profiler saw no device activity) {tag}")
    del profiled

    # bounds at each row's timed shape: bytes each input read once and
    # each output written once; operations as the plain version does them
    f4 = 4                                 # bytes of an f32 value
    hw_in, hw_up, hw_mo = IN_H * IN_W, OUT_H * OUT_W, 1088 * IN_W
    taps = 6                               # Lanczos-3
    table_bytes = (OUT_H + OUT_W) * taps * 8
    k_r = (2 * RADIUS + 1) ** 2            # candidates at r = 16
    s2_out, s2_cin = 1080 * 1920, 4
    chain_hw = 540 * 960
    chain_w_n = 9 * (17 * 64 + 64 * 64 + 64 * 5)
    bounds = {
        # int32 wire in, four f32 planes out; one multiply per value
        "unpack": bound(hw_in * (4 + 4 * f4), 4 * hw_in),
        # a 2x2 mean: three adds and a multiply per output value
        "box2": bound(4 * hw_mo * f4 * 5 / 4, 4 * (hw_mo // 4) * 4),
        # four planes and the tap tables in, packed int32 out; the
        # resample plus clamp and scale per value
        "lanczos_packed": bound(
            4 * hw_in * f4 + table_bytes + hw_up * 4,
            lanczos_ops(4, IN_H, OUT_H, OUT_W, taps) + 4 * hw_up * 2),
        # per candidate and site row: 3C operations per pixel of the b = 8
        # block rows (C subtracts, C multiplies, C - 1 adds, a sqrt), the
        # column and row box sums, the compare
        "motion_sites": bound(
            2 * 4 * hw_mo * f4 + 2 * (1088 // 16) * IN_W * f4,
            k_r * (1088 // 16) * IN_W * (3 * 4 * 8 + 2 * 7 + 1)),
        # per candidate and pixel: 3C for the distance, the separable
        # 16 x 16 box sum (15 + 15 adds), the compare
        "motion_tiled": bound(2 * 4 * hw_mo * f4 + 2 * hw_mo * f4,
                              k_r * hw_mo * (3 * 4 + 2 * 15 + 1)),
        # 2 * 9 * Cin * Cout multiply-adds per output pixel, bf16 operands
        "conv_s2": bound(4 * OUT_H * OUT_W * f4 + 32 * s2_out * f4,
                         2 * 9 * s2_cin * 32 * s2_out + 32 * s2_out, "bf16"),
        # three convs 17 -> 64 -> 64 -> 5, bf16 operands
        "conv_chain": bound((17 + 5) * chain_hw * f4,
                            2 * chain_w_n * chain_hw, "bf16"),
        # [4, 1080, 1920] -> 4K in f32
        "lanczos_planar": bound(4 * hw_in * f4 + table_bytes + 4 * hw_up * f4,
                                lanczos_ops(4, IN_H, OUT_H, OUT_W, taps)),
        # prev and curr in, out; two bilinear samples (9 operations each)
        # and the masked blend (5) per value
        "warp_block": bound(3 * 4 * hw_mo * f4
                            + 2 * (1088 // 16) * (IN_W // 16) * f4,
                            4 * hw_mo * 23),
    }
    # the engine warp at each case: frames in (curr only in blend mode), the
    # MVs, the (cropped) output; per output value the domain round trip (2),
    # per tap row a horizontal lerp (3) and the vertical lerp (3) where
    # fractional, the masked blend (5) per side pair
    for label, (a, b, mv, kw, crop) in engine_in.items():
        c_, h_, w_ = a.shape
        single = kw.get("single", False)
        out_n = c_ * (crop[0] * crop[1] if crop else h_ * w_)
        frac = not kw.get("integer_offsets", False)
        per = (2 + (9 if frac else 0)) * (1 if single else 2) + (
            0 if single else 5)
        bounds[f"warp_matmul {label}"] = bound(
            warp_bytes[f"warp_matmul {label}"], out_n * per)
        print(f"phase 5: warp_matmul {label} {list(a.shape)} bound "
              f"{bounds[f'warp_matmul {label}'][0]:.4f} ms "
              f"({bounds[f'warp_matmul {label}'][1]}) {tag}")
    bounds["warp_matmul"] = bounds["warp_matmul config 5 tail"]
    # the per-pixel warp's pair: per output value and side two bands'
    # fractional warps (the domain, a horizontal lerp per tap row, the
    # vertical lerp: 11) and their blend (3), per pixel and side the mask
    # (the offsets' vertical resize in both axes and the range tests: 12);
    # per pixel the fallback's terms and the cells' sums (14)
    hw_q = API_H * IN_W
    bounds["warp_obmc"] = bound(
        warp_bytes["warp_obmc [4,1088,1920] pair"],
        2 * (4 * hw_q * (2 * 11 + 3 + 1) + hw_q * 12) + hw_q * 14)
    # the epilogue: per output value the base blend (5), the occlusion (4)
    # and the fallback (6); per pixel the channel means (12), the cells'
    # resizes (6 fused lerps) and the ratio and clamps (6)
    bounds["warp_epilogue"] = bound(
        warp_bytes["warp_epilogue [4,1088,1920] occlusion + fallback"],
        4 * IN_H * IN_W * 15 + IN_H * IN_W * 36)
    library["warp_matmul"] = library["warp_matmul tail"]
    # the y4m egress: per pixel ~30 integer operations (three channel
    # extracts, three 3-tap fixed-point sums, shifts, offsets, clips; the
    # chroma sums), on the CUDA cores, counted at their f32 rate; bytes
    # bound it: the frame in, the payload out
    for chroma in ("420", "444"):
        out_n = 3 * OUT_H * OUT_W // (2 if chroma == "420" else 1)
        bounds[f"yuv C{chroma}"] = bound(4 * OUT_H * OUT_W + out_n,
                                         30 * OUT_H * OUT_W)
        print(f"phase 5: yuv [{OUT_H},{OUT_W}] C{chroma} bound "
              f"{bounds[f'yuv C{chroma}'][0]:.4f} ms "
              f"({bounds[f'yuv C{chroma}'][1]}) {tag}")
    bounds["yuv"] = bounds["yuv C420"]
    # the exact path's scale, per 4K pixel: 36 taps' weight products and
    # 35 weight-sum adds (f32), the first colour product (4, f32), then an
    # f64 multiply and add per tap and channel (the fused form, 35 x 4);
    # per value the division, x 255, the clamp and the round (5, f32);
    # bytes: the frame in, the tap tables (index, weight, flag: 9 bytes a
    # tap), the UNORM8 frame out
    bounds["oracle_scale"] = bound(
        4 * hw_in * f4 + (OUT_H + OUT_W) * taps * 9 + 4 * hw_up,
        {"f32": hw_up * (36 + 35 + 4 + 4 * 5), "f64": hw_up * 35 * 4 * 2})
    # the exact path's warp at t = 0.5, per pixel and sample: the uv step
    # (4, f32: not fused at t = 0.5), the range test (4), floor, fraction
    # and 1 - f per axis (6), the two positions (fused: 4 f64); per value
    # and sample three lerps, per value the blend (an f32 product, an f64
    # multiply and add each); bytes: prev, curr and the MV field in, out
    bounds["oracle_warp"] = bound(
        3 * ex_a.nbytes + ex_mv.nbytes,
        {"f32": hw_in * (2 * 14 + 4 * 7), "f64": hw_in * (2 * 4 + 4 * 14)})
    # the tiled search at the exact path's shape, per candidate and pixel:
    # the distance (3C), the exact 8 x 8 box (63 adds), the compare
    bounds["motion_tiled_exact"] = bound(
        2 * 4 * hw_in * f4 + 2 * hw_in * f4,
        k_r * hw_in * (3 * 4 + 63 + 1))
    for name in ("oracle_scale", "oracle_warp", "motion_tiled_exact"):
        print(f"phase 5: {name} bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}) {tag}")

    def row(name, source, replaces, err, timing):
        ms, by = bounds[name]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": path_launches[name],
               "max_abs_err": err, "ms": timings[timing][0],
               "plain_ms": timings[timing][1], "bound_ms": ms,
               "bound_by": by, "library_ms": library.get(name)}
        if timing in device_ms:
            out["device_ms"] = device_ms[timing]
        return out

    summary = {"kernels": [
        row("unpack", "tpufg_torch/csrc/unpack.cu",
            "tpufg/kernels/convert.py:36", unpack_err, "unpack"),
        row("box2", "tpufg_torch/csrc/box2.cu",
            "tpufg/kernels/resize.py:33", box_err, "box2 [4, 1088, 1920]"),
        row("lanczos_packed", "tpufg_torch/csrc/lanczos_packed.cu",
            "tpufg/kernels/lanczos.py:209", lanczos_err,
            "lanczos 1080x1920->2160x3840 a=3"),
        row("lanczos_planar", "tpufg_torch/csrc/lanczos_planar.cu",
            "tpufg/kernels/lanczos.py:131", fast_err,
            f"lanczos_fast [4,1080,1920]->{OUT_H}x{OUT_W} torch.float32"),
        row("motion_sites", "tpufg_torch/csrc/motion_sites.cu",
            "tpufg/kernels/motion.py:164", sites_err,
            f"sites [4, 1088, 1920] r={RADIUS}"),
        row("motion_tiled", "tpufg_torch/csrc/motion_tiled.cu",
            "tpufg/kernels/motion.py:47", tiled_err,
            f"tiled [4, 1088, 1920] b=16 r={RADIUS} exact_box=False"),
        row("conv_s2", "tpufg_torch/csrc/conv_s2_mma.cu",
            "tpufg/kernels/conv.py:37", s2_err,
            "conv3x3_s2 [4, 2160, 3840] torch.bfloat16"),
        row("conv_chain", "tpufg_torch/csrc/conv_chain_mma.cu",
            "tpufg/kernels/conv.py:161", chain_err,
            "conv3x3_chain [17, 540, 960] bf16, weights already packed"),
        row("warp_block", "tpufg_torch/csrc/warp_block.cu",
            "tpufg/kernels/warp.py:39", warp_err,
            f"warp_block [4,{API_H},{IN_W}] t=0.5"),
        # an XLA op of the reference, not a Pallas kernel
        row("warp_matmul", "tpufg_torch/csrc/warp_matmul.cu",
            "tpufg/kernels/warp_matmul.py:256 (XLA op, not Pallas)",
            engine_err, "warp_matmul config 5 tail"),
        # XLA ops of the reference too: the per-pixel branch of _warp_one
        # and the blend options' tail of warp_blend_matmul
        row("warp_obmc", "tpufg_torch/csrc/warp_obmc.cu",
            "tpufg/kernels/warp_matmul.py:136 (XLA op, not Pallas)",
            obmc_err, "warp_obmc [4,1088,1920] pair"),
        row("warp_epilogue", "tpufg_torch/csrc/warp_epilogue.cu",
            "tpufg/kernels/warp_matmul.py:422 (XLA op, not Pallas)",
            epi_err, "warp_epilogue [4,1088,1920] occlusion + fallback"),
        # an XLA op of the reference: the device-side y4m egress (C420;
        # bitwise, so its error is 0)
        row("yuv", "tpufg_torch/csrc/yuv.cu",
            "tpufg/kernels/yuv.py:56 (XLA op, not Pallas)", 0.0,
            f"yuv [{OUT_H},{OUT_W}] C420"),
        # the exact path: two XLA ops of the reference's oracle (bitwise,
        # max |d| in codes and in values), and the tiled search at its
        # shape with the exact box
        row("oracle_scale", "tpufg_torch/csrc/oracle_scale.cu",
            "tpufg/ops/oracle.py:93 + :309 (XLA ops, not Pallas)",
            float(ex_scale_err), "oracle_scale 1080p->4K"),
        row("oracle_warp", "tpufg_torch/csrc/oracle_warp.cu",
            "tpufg/ops/oracle.py:247 (XLA op, not Pallas)", ex_warp_err,
            "oracle_warp 1080p t=0.5"),
        row("motion_tiled_exact", "tpufg_torch/csrc/motion_tiled.cu",
            "tpufg/kernels/motion.py:47", tiled_exact_err, tiled_ex_label),
        # RAFT's (config 7), timed on the arguments its path gives them
        *c7["rows"],
    ]}
    check(not [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "tpufg")],
          "jax or tpufg was imported")
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
