#!/usr/bin/env python3
"""Smoke run of tpufg_torch on one CUDA card: build, check, drive, time.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each one checks its results and raises on a failure, so the exit
code is non-zero and no result line is printed):

1. the card (nvidia-smi name and power limit, torch and CUDA versions) and
   the nvcc build of tpufg_torch/csrc/*.cu, with its time and ptxas report;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the 1080p -> 4K main path gives it (unpack and box2 bitwise;
   Lanczos within 1 code on at most 1e-4 of the bytes);
3. the main path through the command line, ``synthetic:1920x1080`` ->
   3840x2160 over 48 frames, with the kernels' launch counts read from a
   zeroed start: every kernel must have run on every frame (pair);
4. the kernel path against the plain path on the same three frames (MV
   fields bitwise, output bytes within 1 code), and the in-between frame
   of an even pan against the exactly shifted source;
5. timing with CUDA events: the step at 1080p -> 4K (ms per pair p50/p99,
   output fps) and each kernel beside its plain version.

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
N_FRAMES = 48
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


def time_pair(kernel_fn, plain_fn) -> tuple[float, float]:
    """Kernel and plain ms, measured in turns (k, p, p, k) and averaged."""
    k1, p1, p2, k2 = (time_ms(kernel_fn), time_ms(plain_fn),
                      time_ms(plain_fn), time_ms(kernel_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def pan_frames(n: int, velocity=(4.0, 2.0)):
    """n synthetic pan frames as packed int32 [H, W] numpy arrays."""
    from tpufg.io.sources import SyntheticSource
    src = SyntheticSource(IN_W, IN_H, n_frames=n, velocity=velocity)
    return [f.view(np.int32).reshape(IN_H, IN_W) for f in src]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from tpufg.config import EngineConfig
    from tpufg_torch import cli
    from tpufg_torch.engine.pipeline import interp_planar, make_interp_step
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels.convert import (frames_to_planar,
                                             frames_to_planar_plain)
    from tpufg_torch.kernels.lanczos import (lanczos_scale_packed,
                                             lanczos_scale_packed_plain)
    from tpufg_torch.kernels.resize import (box_downsample2,
                                            box_downsample2_plain)

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

    # ---- phase 2: each kernel vs its plain version at the path's shapes
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
    torch.cuda.synchronize()

    # ---- phase 3: the main path through the command line
    kernels = (frames_to_planar, box_downsample2, lanczos_scale_packed)
    for fn in kernels:
        fn.launches = 0
    rc, stats = cli.run([f"synthetic:{IN_W}x{IN_H}", "--output-width",
                         str(OUT_W), "--output-height", str(OUT_H),
                         "--frames", str(N_FRAMES), "--no-pacing",
                         "--output", "null"])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    check(rc == 0, f"cli exit code {rc}")
    pairs = stats.frames_in - 1
    print(f"phase 3: cli rc {rc}, frames in {stats.frames_in}, out "
          f"{stats.frames_out}, launches {launches}, host fps "
          f"{stats.fps:.2f} {tag}")
    check(stats.frames_in == N_FRAMES, "frames_in")
    check(stats.frames_out == 2 * stats.frames_in - 1, "frames_out")
    check(launches["frames_to_planar"] == 2 * pairs + 1, "unpack launches")
    check(launches["box_downsample2"] == 4 * pairs, "box2 launches")
    check(launches["lanczos_scale_packed"] == 2 * pairs + 1,
          "lanczos launches")

    # ---- phase 4: kernel path vs plain path, and a known answer
    cfg = EngineConfig(input_width=IN_W, input_height=IN_H,
                       output_width=OUT_W, output_height=OUT_H)
    frames = [torch.from_numpy(f).to(dev) for f in pan_frames(3)]
    step_k = make_interp_step(cfg, wire="i32", device=dev, impl="kernel")
    step_p = make_interp_step(cfg, wire="i32", device=dev, impl="plain")
    for i in range(2):
        prev, curr = frames[i], frames[i + 1]
        mvs, mids = [], []
        for impl, unpack in (("kernel", frames_to_planar),
                             ("plain", frames_to_planar_plain)):
            mid, mv = interp_planar(unpack(prev), unpack(curr),
                                    mode="pyramid", factors=[0.5],
                                    dt=torch.bfloat16, block_size=8,
                                    search_radius=16, return_mv=True,
                                    impl=impl)
            mvs.append(mv)
            mids.append(mid[0])
        check(bits_equal(mvs[0], mvs[1]), f"pair {i}: MV fields differ")
        outs_k, outs_p = step_k(prev, curr), step_p(prev, curr)
        for ok_, op_ in zip(outs_k, outs_p):
            check(tuple(ok_.shape) == (OUT_H, OUT_W), "output shape")
            mx, nd, nb = byte_diff(ok_, op_)
            check(mx <= 1, f"pair {i}: kernel vs plain output bytes {mx}")
        # an even pan (4, 2) px/frame: interior MVs are exactly (4, 2) and
        # the in-between frame is the source shifted by (2, 1)
        mv = mvs[0][:, 2:-3, 2:-2]
        hit = float(((mv[0] == 4) & (mv[1] == 2)).float().mean())
        mid = mids[0]
        check(bool(torch.isfinite(mid).all()), "in-between frame not finite")
        ref = frames_to_planar_plain(prev)[:, 1:, 2:]   # prev shifted (2, 1)
        inner = (slice(None), slice(32, IN_H - 32), slice(32, IN_W - 32))
        same = float((mid[:, :-1, :-2][inner] == ref[inner]).float().mean())
        print(f"phase 4: pair {i}: MV bitwise equal, outputs within 1 code "
              f"(last pair {nd} of {nb} bytes differ); pan MV hit rate "
              f"{hit:.4f}, midpoint == shifted source on {same:.4f}")
        check(hit >= 0.95, "pan MV not recovered")
        check(same >= 0.99, "midpoint does not match the shifted source")

    # ---- phase 5: timing
    step = make_interp_step(cfg, wire="i32", device=dev)
    ev = []
    for j in range(60):
        prev, curr = frames[j % 2], frames[j % 2 + 1]
        if j < 10:
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
    fps = 2 * len(ev) / (total / 1e3)
    print(f"phase 5: step 1080p->4K over {len(ev)} pairs: p50 "
          f"{np.percentile(per, 50):.3f} ms, p99 {np.percentile(per, 99):.3f}"
          f" ms per pair, steady {fps:.1f} output fps {tag}")

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
    for name, (km, pm) in timings.items():
        print(f"phase 5: {name}: kernel {km:.4f} ms, plain {pm:.4f} ms {tag}")

    summary = {"kernels": [
        {"name": "unpack", "route": "cuda",
         "source": "tpufg_torch/csrc/unpack.cu",
         "replaces": "tpufg/kernels/convert.py:36",
         "launches": launches["frames_to_planar"],
         "max_abs_err": unpack_err,
         "ms": timings["unpack"][0], "plain_ms": timings["unpack"][1]},
        {"name": "box2", "route": "cuda",
         "source": "tpufg_torch/csrc/box2.cu",
         "replaces": "tpufg/kernels/resize.py:33",
         "launches": launches["box_downsample2"],
         "max_abs_err": box_err,
         "ms": timings["box2 [4, 1088, 1920]"][0],
         "plain_ms": timings["box2 [4, 1088, 1920]"][1]},
        {"name": "lanczos_packed", "route": "cuda",
         "source": "tpufg_torch/csrc/lanczos_packed.cu",
         "replaces": "tpufg/kernels/lanczos.py:209",
         "launches": launches["lanczos_scale_packed"],
         "max_abs_err": lanczos_err,
         "ms": timings["lanczos 1080x1920->2160x3840"][0],
         "plain_ms": timings["lanczos 1080x1920->2160x3840"][1]},
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
