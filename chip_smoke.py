#!/usr/bin/env python3
"""Smoke run of tpufg_torch on one CUDA card: build, check, drive, time.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Two paths are driven: config 4 (``synthetic:1920x1080`` -> 3840x2160,
pyramid motion) and config 3 (1920x1080 at identity size, exhaustive
block matching at r = 16, the fractional warp).  Phases (each one checks
its results and raises on a failure, so the exit code is non-zero and no
result line is printed):

1. the card (nvidia-smi name and power limit, torch and CUDA versions) and
   the nvcc build of tpufg_torch/csrc/*.cu, with its time and ptxas report;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the two paths give it (unpack, box2 and both motion searches
   bitwise; Lanczos within 1 code on at most 1e-4 of the bytes);
3. each path through the command line (config 4 over 24 frames, config 3
   over 16, config 3 at ``--block-size 16`` over 4), each with the
   kernels' launch counts read from a zeroed start: every kernel of the
   path must have run on every frame (pair), and no other;
4. the kernel path against the plain path on the same three frames of an
   even pan (MV fields bitwise, output bytes within 1 code), the pan's
   velocity in the MV field, and the in-between frame against the exactly
   shifted source, for each path;
5. timing with CUDA events: each step (ms per pair p50/p99, output fps),
   config 3's stages, and each kernel beside its plain version.

The last three lines of standard output are the kernel summary (JSON), the
card's ``name, power.limit`` and ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 2 before any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

IN_W, IN_H, OUT_W, OUT_H = 1920, 1080, 3840, 2160
N_FRAMES = 24             # config-4 CLI run
C3_FRAMES = 16            # config-3 CLI run
C3_B16_FRAMES = 4         # config 3 at --block-size 16 (the tiled search)
RADIUS = 16               # config 3's search radius
LANCZOS_MAX_FRAC = 1e-4   # bytes allowed to differ by one code


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


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


def step_times(step, frames, n: int = 50, warmup: int = 10):
    """(p50, p99 ms per pair, steady output fps) of ``step`` over
    ``n`` pairs after ``warmup``, CUDA events around each call."""
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
            2 * len(ev) / (total / 1e3))


def pan_frames(n: int, velocity=(4.0, 2.0)):
    """n synthetic pan frames as packed int32 [H, W] numpy arrays."""
    from tpufg.io.sources import SyntheticSource
    src = SyntheticSource(IN_W, IN_H, n_frames=n, velocity=velocity)
    return [f.view(np.int32).reshape(IN_H, IN_W) for f in src]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from tpufg.config import EngineConfig
    from tpufg_torch.engine import pipeline
    from tpufg_torch.engine.pipeline import interp_planar, make_interp_step
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels.convert import (frames_to_planar,
                                             frames_to_planar_plain,
                                             planar_to_i32)
    from tpufg_torch.kernels.lanczos import (lanczos_scale_packed,
                                             lanczos_scale_packed_plain)
    from tpufg_torch.kernels.motion import (motion_search_sites,
                                            motion_search_sites_plain,
                                            motion_search_tiled,
                                            motion_search_tiled_plain,
                                            sites_tile_w)
    from tpufg_torch.kernels.resize import (box_downsample2,
                                            box_downsample2_plain)
    from tpufg_torch.kernels.warp_matmul import warp_blend_matmul

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

    lanczos_err = 0
    scale_in = {}
    for (ih, iw), (oh, ow) in (((1080, 1920), (2160, 3840)),
                               ((720, 1280), (1440, 2560)),
                               ((1080, 1920), (1440, 2560))):
        x = codes((4, ih, iw))
        scale_in[(ih, iw, oh, ow)] = x
        k = lanczos_scale_packed(x, oh, ow, raw_i32=True)
        p = lanczos_scale_packed_plain(x, oh, ow, raw_i32=True)
        mx, nd, nb = byte_diff(k, p)
        print(f"phase 2: lanczos [4,{ih},{iw}] -> {oh}x{ow}: max |d| {mx} "
              f"code, {nd} of {nb} bytes differ")
        check(mx <= 1 and nd <= LANCZOS_MAX_FRAC * nb,
              f"lanczos kernel vs plain at {ih}x{iw}->{oh}x{ow}")
        lanczos_err = max(lanczos_err, mx)

    def moved_pair(shape):
        # curr = prev moved by (-2, 3) with an unrelated band on top, so
        # some blocks have a zero-cost winner and some have none
        prev = codes(shape)
        curr = torch.roll(prev, (3, -2), (1, 2))
        curr[:, :16] = codes((shape[0], 16, shape[2]))
        return prev, curr

    motion_in = {}
    sites_err = 0.0
    for shape in ((4, 1088, 1920), (3, 1088, 1920)):
        pr, cu = moved_pair(shape)
        motion_in[("sites",) + shape] = (pr, cu)
        k = motion_search_sites(pr, cu, search_radius=RADIUS, dx_chunk=3)
        p = motion_search_sites_plain(pr, cu, search_radius=RADIUS)
        check(bits_equal(k, p), f"sites kernel != plain at {shape}")
        sites_err = max(sites_err, float((k - p).abs().max()))
        print(f"phase 2: sites {list(shape)} r={RADIUS} bitwise equal "
              f"(zero MVs {float((k == 0).all(0).float().mean()):.4f})")
    tiled_err = 0.0
    for shape, b, r, exact in (((4, 1088, 1920), 16, RADIUS, False),
                               ((4, 272, 480), 12, 4, False),
                               ((4, 256, 512), 8, RADIUS, True)):
        pr, cu = moved_pair(shape)
        motion_in[("tiled", b, r, exact) + shape] = (pr, cu)
        k = motion_search_tiled(pr, cu, block_size=b, search_radius=r,
                                exact_box=exact)
        p = motion_search_tiled_plain(pr, cu, b, r, exact_box=exact)
        check(bits_equal(k, p), f"tiled kernel != plain at {shape} b={b} "
              f"r={r} exact_box={exact}")
        tiled_err = max(tiled_err, float((k - p).abs().max()))
        print(f"phase 2: tiled {list(shape)} b={b} r={r} exact_box={exact} "
              "bitwise equal")
    torch.cuda.synchronize()

    # ---- phase 3: each path through the command line, counts from 0
    kernels = (frames_to_planar, box_downsample2, lanczos_scale_packed,
               motion_search_sites, motion_search_tiled)
    runs = {}
    for name, argv, n in (
            ("config 4", ["--output-width", str(OUT_W), "--output-height",
                          str(OUT_H)], N_FRAMES),
            ("config 3", ["--motion-mode", "exhaustive"], C3_FRAMES),
            ("config 3 b16", ["--motion-mode", "exhaustive",
                              "--block-size", "16"], C3_B16_FRAMES)):
        rc, stats, launches = drive(
            [f"synthetic:{IN_W}x{IN_H}", *argv, "--frames", str(n),
             "--no-pacing", "--output", "null"], kernels)
        check(rc == 0, f"{name}: cli exit code {rc}")
        pairs = stats.frames_in - 1
        print(f"phase 3: {name}: cli rc {rc}, frames in {stats.frames_in}, "
              f"out {stats.frames_out}, launches {launches}, host fps "
              f"{stats.fps:.2f} {tag}")
        check(stats.frames_in == n, f"{name}: frames_in")
        check(stats.frames_out == 2 * stats.frames_in - 1,
              f"{name}: frames_out")
        runs[name] = (pairs, launches)
    pairs, launches = runs["config 4"]
    check(launches == {"frames_to_planar": 2 * pairs + 1,
                       "box_downsample2": 4 * pairs,
                       "lanczos_scale_packed": 2 * pairs + 1,
                       "motion_search_sites": 0,
                       "motion_search_tiled": 0}, "config 4 launches")
    # identity size: the first frame and every curr pass through unscaled
    pairs, launches = runs["config 3"]
    check(launches == {"frames_to_planar": 2 * pairs,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": pairs,
                       "motion_search_tiled": 0}, "config 3 launches")
    pairs, launches = runs["config 3 b16"]
    check(launches == {"frames_to_planar": 2 * pairs,
                       "box_downsample2": 0, "lanczos_scale_packed": 0,
                       "motion_search_sites": 0,
                       "motion_search_tiled": pairs},
          "config 3 --block-size 16 launches")
    path_launches = {
        "unpack": runs["config 4"][1]["frames_to_planar"],
        "box2": runs["config 4"][1]["box_downsample2"],
        "lanczos_packed": runs["config 4"][1]["lanczos_scale_packed"],
        "motion_sites": runs["config 3"][1]["motion_search_sites"],
        "motion_tiled": runs["config 3 b16"][1]["motion_search_tiled"]}

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
        step_k = make_interp_step(cfg, wire="i32", device=dev, impl="kernel")
        step_p = make_interp_step(cfg, wire="i32", device=dev, impl="plain")
        for i in range(2):
            prev, curr = frames[i], frames[i + 1]
            mvs, mids = [], []
            for impl, unpack in (("kernel", frames_to_planar),
                                 ("plain", frames_to_planar_plain)):
                mid, mv = interp_planar(unpack(prev), unpack(curr),
                                        mode=cfg.motion_mode, factors=[0.5],
                                        dt=torch.bfloat16, block_size=8,
                                        search_radius=RADIUS, return_mv=True,
                                        impl=impl)
                mvs.append(mv)
                mids.append(mid[0])
            check(bits_equal(mvs[0], mvs[1]), f"{name} pair {i}: MV fields "
                  "differ")
            outs_k, outs_p = step_k(prev, curr), step_p(prev, curr)
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

    # ---- phase 5: timing
    for name, (cfg, _) in cfgs.items():
        p50, p99, fps = step_times(make_interp_step(cfg, wire="i32",
                                                    device=dev), frames)
        print(f"phase 5: {name} step over 50 pairs: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms per pair, steady {fps:.1f} output fps {tag}")

    # config 3's stages, each bracketed by events and synchronised
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
    for j in range(n_st + 3):
        if j == 3:
            stages.clear()   # three warm-up pairs
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
        mid = stage("fractional warp + blend, 1088x1920 (plain torch)",
                    lambda: warp_blend_matmul(
                        pp, cp, -mv, factor=0.5, search_radius=RADIUS,
                        dtype=torch.bfloat16, u8_exact=True))
        stage("crop + pack to the i32 wire (plain torch)",
              lambda: planar_to_i32(mid[:, :IN_H].contiguous()))
    for label, ms in stages.items():
        print(f"phase 5: config 3 stage {label}: {ms / n_st:.4f} ms per pair "
              f"{tag}")
    print(f"phase 5: config 3 sum of synchronised stages "
          f"{sum(stages.values()) / n_st:.4f} ms per pair {tag}")

    timings = {}
    timings["unpack"] = time_pair(lambda: frames_to_planar(wire),
                                  lambda: frames_to_planar_plain(wire))
    for shape, x in box_in.items():
        timings[f"box2 {list(shape)}"] = time_pair(
            lambda x=x: box_downsample2(x),
            lambda x=x: box_downsample2_plain(x))
    for (ih, iw, oh, ow), x in scale_in.items():
        timings[f"lanczos {ih}x{iw}->{oh}x{ow}"] = time_pair(
            lambda x=x, oh=oh, ow=ow: lanczos_scale_packed(
                x, oh, ow, raw_i32=True),
            lambda x=x, oh=oh, ow=ow: lanczos_scale_packed_plain(
                x, oh, ow, raw_i32=True))
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
    for name, (km, pm) in timings.items():
        print(f"phase 5: {name}: kernel {km:.4f} ms, plain {pm:.4f} ms {tag}")

    def row(name, source, replaces, err, timing):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches[name],
                "max_abs_err": err, "ms": timings[timing][0],
                "plain_ms": timings[timing][1]}

    summary = {"kernels": [
        row("unpack", "tpufg_torch/csrc/unpack.cu",
            "tpufg/kernels/convert.py:36", unpack_err, "unpack"),
        row("box2", "tpufg_torch/csrc/box2.cu",
            "tpufg/kernels/resize.py:33", box_err, "box2 [4, 1088, 1920]"),
        row("lanczos_packed", "tpufg_torch/csrc/lanczos_packed.cu",
            "tpufg/kernels/lanczos.py:209", lanczos_err,
            "lanczos 1080x1920->2160x3840"),
        row("motion_sites", "tpufg_torch/csrc/motion_sites.cu",
            "tpufg/kernels/motion.py:164", sites_err,
            f"sites [4, 1088, 1920] r={RADIUS}"),
        row("motion_tiled", "tpufg_torch/csrc/motion_tiled.cu",
            "tpufg/kernels/motion.py:47", tiled_err,
            f"tiled [4, 1088, 1920] b=16 r={RADIUS} exact_box=False"),
    ]}
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
