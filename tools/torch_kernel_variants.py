#!/usr/bin/env python3
"""Time tpufg_torch's redesigned kernels, their variants and their parent
on one CUDA card.

    python3 tools/torch_kernel_variants.py              # this tree
    python3 tools/torch_kernel_variants.py --variants   # compile-time variants
    python3 tools/torch_kernel_variants.py --variants chain   # one kernel:
                            # chain, tiled, sites, lanczos, planar, s2,
                            # warp (both block warps) or obmc
    python3 tools/torch_kernel_variants.py --parent DIR # DIR's tree vs this
    python3 tools/torch_kernel_variants.py --parent DIR --only 4q
                            # config 4q's warp_obmc and warp_epilogue alone

Run from the repository root.  The default mode checks config 4q's
``warp_obmc`` (pair, blend and single, bf16) and ``warp_epilogue`` (its
option sets) at [4,1088,1920], with their device times, registers and
blocks per SM, then ``conv3x3_chain``
(bf16, the bundled head's weights, [17,540,960] and [13,540,960]),
``motion_search_tiled`` (the three shapes chip_smoke.py times),
``motion_search_sites`` ([4,1088,1920] and [3,1088,1920] at r = 16) and
``lanczos_scale_packed`` (1080p -> 4K, 720p -> 1440p, 1080p -> 1440p,
1440p -> 1080p and 4K -> 1080p), ``lanczos_scale_fast`` (C = 4 in f32 and
bf16, C = 3 and C = 17 upscales, the two downscales) and ``conv3x3_s2``
(bf16 at [4,2160,3840] and [8,1080,1920], f32 at [4,540,960]),
``warp_blend_block`` ([4,1088,1920] b16 r16: t = 0.5, 0.25, single) and the
engine's ``warp_blend_matmul`` (each path's shape and mode, chip_smoke.py's
ENGINE_WARPS) against their plain versions, times them with CUDA events and
prints one JSON object; the convs' timed calls reuse the packed weights.
The warps also get a device time, ``device_ms``: chip_smoke.py's
``graph_ms``, 100 calls captured in a CUDA graph that cycles through copies
of the operands past twice the L2, so the wrapper's host cost per call is
left out (at the engine's smaller shapes it exceeds the kernel's time).
``--variants`` rebuilds one source alone with other compile-time splits
(the tiled search's rows per tile and groups per block; the chain's warps
per block, m16 tiles per warp and taps unrolled; the sites search's dy
candidates per barrier; the Lanczos tile's columns, with its rows from the
plan; the bf16 stride-2 conv's tile shape and epilogue; the two block
warps' columns and rows a thread, thread rows a block and channels
walked together, built eight at a time and timed by graph; the same four
knobs of the per-pixel warp, ``-DOBMC_*``), checks each against the
library's result and times it; the planar Lanczos' tile rows and channel
groups are launch arguments and need no rebuild.
``--parent DIR`` runs the default mode in DIR (an unpacked earlier commit)
and here as subprocesses, in turns parent, change, change, parent, so both
are timed on the same card in one run.  Every line carries the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

# the warp cases, the MV draw and the timers are chip_smoke.py's, the one
# beside this file (under --parent the working directory is another tree)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
card, time_ms, graph_ms = smoke.card_line, smoke.time_ms, smoke.graph_ms

TILED_SHAPES = (((4, 1088, 1920), 16, 16, False),
                ((4, 272, 480), 12, 4, False),
                ((4, 256, 512), 8, 16, True))
SITES_SHAPES = ((4, 1088, 1920), (3, 1088, 1920))
SITES_RADIUS = 16
LANCZOS_SHAPES = (((1080, 1920), (2160, 3840)), ((720, 1280), (1440, 2560)),
                  ((1080, 1920), (1440, 2560)), ((1440, 2560), (1080, 1920)),
                  ((2160, 3840), (1080, 1920)))
# lanczos_scale_fast: (channels, input, output, "f32" or "bf16")
PLANAR_SHAPES = ((4, (1080, 1920), (2160, 3840), "f32"),
                 (4, (1080, 1920), (2160, 3840), "bf16"),
                 (3, (720, 1280), (1440, 2560), "f32"),
                 (17, (540, 960), (1080, 1920), "f32"),
                 (4, (1440, 2560), (1080, 1920), "f32"),
                 (4, (2160, 3840), (1080, 1920), "f32"))
# further downscales, for --variants planar: where the walk gives way
PLANAR_DOWNSCALES = ((4, (2160, 3840), (720, 1280), "f32"),
                     (4, (2160, 3840), (540, 960), "f32"),
                     (4, (2160, 3840), (360, 640), "f32"))
# conv3x3_s2: (input shape, output channels, "f32" or "bf16")
S2_SHAPES = (((4, 2160, 3840), 32, "bf16"), ((8, 1080, 1920), 32, "bf16"),
             ((4, 540, 960), 32, "f32"))
# --variants warp: (columns V and rows RT a thread, thread rows a block,
# channels walked together)
WARP_VARIANTS = ((4, 2, 4, 2), (4, 2, 8, 2), (4, 2, 8, 4), (4, 2, 4, 4),
                 (4, 2, 4, 1), (4, 2, 8, 1), (2, 2, 8, 2), (2, 2, 4, 2),
                 (2, 2, 8, 4), (4, 4, 4, 2), (4, 1, 8, 2), (1, 1, 8, 2))


def planar_inputs(shapes=PLANAR_SHAPES):
    """lanczos_scale_fast's frames and conv3x3_s2's inputs and weights, from
    a seed: {shape key: tensor} and {shape key: (x, w, b, dtype)}."""
    import numpy as np
    import torch
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def codes(shape):
        q = rng.integers(0, 256, shape).astype(np.float32)
        return torch.from_numpy(q * np.float32(1 / 255)).to(dev)

    planar = {key: codes((key[0], *key[1])).to(dts[key[3]])
              for key in shapes}
    s2 = {}
    for key in S2_SHAPES:
        shape, cout, dt = key
        w = torch.from_numpy(rng.normal(0, .2, (cout, shape[0], 3, 3))
                             .astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, .1, (cout,)).astype(np.float32)
                             ).to(dev)
        s2[key] = (codes(shape), w, b, dts[dt])
    return planar, s2


def warp_inputs():
    """The block warp's frames and MVs ({label: (prev, curr, mv, kwargs)},
    at [4, 1088, 1920] b16 r16) and the engine warp's ({label: (prev, curr,
    mv, kwargs, crop)}), from a seed: code-valued frames, MVs drawn by
    chip_smoke.py's ``warp_mvs``."""
    import numpy as np
    import torch
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)

    def codes(shape):
        q = rng.integers(0, 256, shape).astype(np.float32)
        return torch.from_numpy(q * np.float32(1 / 255)).to(dev)

    def mvs(shape, g, r, whole, single):
        return torch.from_numpy(smoke.warp_mvs(rng, shape, g, r, whole,
                                               single)).to(dev)

    shape = (4, smoke.API_H, smoke.IN_W)
    a, b = codes(shape), codes(shape)
    mv = mvs(shape, 16, 16, False, False)
    block = {label: (a, b, mv, dict(kw, block=16, search_radius=16))
             for label, kw in smoke.BLOCK_WARP_MODES.items()}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    engine = {}
    for label, (shape, g, r, whole, kw, crop) in smoke.ENGINE_WARPS.items():
        kw = dict(kw, block=g, search_radius=r)
        kw["dtype"] = dts[kw.get("dtype", "f32")]
        engine[label] = (codes(shape), codes(shape),
                         mvs(shape, g, r, whole, kw.get("single", False)),
                         kw, crop)
    return block, engine


# --variants obmc: (columns and rows a thread, thread rows a block,
# channels walked together) of csrc/warp_obmc.cu
OBMC_VARIANTS = ((1, 4, 4, 4), (1, 4, 4, 2), (2, 4, 4, 4), (2, 4, 4, 2),
                 (1, 4, 2, 4), (1, 4, 8, 4), (1, 2, 8, 4))


def q4_inputs():
    """Config 4q's warp operands at its shape, from a seed: code-valued
    [4, 1088, 1920] frames and continuous MVs past the clip on the 8-px
    lattice (chip_smoke.py's draw)."""
    import numpy as np
    import torch
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    shape = (4, smoke.API_H, smoke.IN_W)

    def codes():
        q = rng.integers(0, 256, shape).astype(np.float32)
        return torch.from_numpy(q * np.float32(1 / 255)).to(dev)

    a, b = codes(), codes()
    mv = torch.from_numpy(smoke.warp_mvs(rng, shape, 8, smoke.RADIUS, False,
                                         False)).to(dev)
    return a, b, mv


def pan_mvs(mv):
    """The MVs of an even (3, 1) px/frame pan on mv's lattice (the 4q pan
    chip_smoke.py's known answer uses): every warp lane's taps in one row."""
    import torch
    return torch.stack([torch.full_like(mv[0], -3.0),
                        torch.full_like(mv[1], -1.0)])


# the per-pixel warp's modes: (keyword arguments, output planes); the
# epilogue's option sets
OBMC_MODES = {"pair": (dict(pair=True), 10),
              "blend": (dict(crop=(1080, 1920)), 4),
              "single": (dict(single=True, crop=(1080, 1920)), 4)}
EPILOGUE_OPTIONS = {"occlusion + fallback": (True, True),
                    "fallback": (False, True), "occlusion": (True, False)}


def run_4q(res: dict) -> None:
    """warp_obmc (pair, blend, single; bf16) and warp_epilogue (its option
    sets, cropped to 1080 rows) at config 4q's shape: bitwise to the plain
    version, a call's ms and the device's (graph_ms), and where the tree
    has the queries, registers, spills and blocks per SM."""
    import torch
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels import warp_matmul as wm
    a, b, mv = q4_inputs()
    lib = common.cuda_lib()
    occ = getattr(lib, "tpufg_warp_obmc_occupancy", None)
    for mode, (kw, planes) in OBMC_MODES.items():
        kw = dict(kw, block=8, search_radius=smoke.RADIUS,
                  dtype=torch.bfloat16)
        k = wm.warp_obmc(a, b, mv, **kw)
        p = wm.warp_obmc_plain(a, b, mv, **kw)
        moved = (1 if kw.get("single") else 2) * a.nbytes + mv.nbytes \
            + k.nbytes
        sets = smoke.operand_sets((a, b, mv), moved)
        entry = {"bitwise": bool(torch.equal(k.view(torch.int32),
                                             p.view(torch.int32))),
                 "ms": time_ms(lambda: wm.warp_obmc(a, b, mv, **kw), 50),
                 "device_ms": graph_ms(
                     lambda a, b, mv: wm.warp_obmc(a, b, mv, **kw), sets,
                     100)}
        if occ is not None:
            m = {"pair": 2, "blend": 1, "single": 0}[mode]
            entry["registers"], entry["blocks_per_sm"], entry["spill"] = (
                occ(m, 1, 4, i) for i in range(3))
        res[f"warp_obmc {mode}"] = entry
        del sets
    # pair mode with the pan's MVs (the 4q stage's case; random MVs above)
    pan = pan_mvs(mv)
    kw = dict(block=8, search_radius=smoke.RADIUS, dtype=torch.bfloat16,
              pair=True)
    k = wm.warp_obmc(a, b, pan, **kw)
    sets = smoke.operand_sets((a, b, pan), 2 * a.nbytes + k.nbytes)
    res["warp_obmc pair, pan MVs"] = {
        "bitwise": bool(torch.equal(
            k.view(torch.int32),
            wm.warp_obmc_plain(a, b, pan, **kw).view(torch.int32))),
        "device_ms": graph_ms(
            lambda a, b, mv: wm.warp_obmc(a, b, mv, **kw), sets, 100)}
    del sets
    # the cell means folded into the warp's pair pass, where the tree has
    # it: that launch alone, and the pair of launches either way (warp,
    # then the epilogue with its own cells pass or with the means given)
    import inspect
    fold = "cells" in inspect.signature(wm.warp_obmc).parameters
    kw = dict(block=8, search_radius=smoke.RADIUS, dtype=torch.bfloat16,
              pair=True)
    both = {"cells pass": lambda a, b, mv: wm.warp_epilogue(
        wm.warp_obmc(a, b, mv, **kw), a, b, 0.5, True, True,
        crop=(1080, 1920))}
    if fold:
        pair_k, cells_k = wm.warp_obmc(a, b, mv, cells=True, **kw)
        pair_p, cells_p = wm.warp_obmc_plain(a, b, mv, cells=True, **kw)
        sets = smoke.operand_sets((a, b, mv), 2 * a.nbytes + pair_k.nbytes)
        res["warp_obmc pair + cells"] = {
            "bitwise": bool(torch.equal(pair_k.view(torch.int32),
                                        pair_p.view(torch.int32))
                            and torch.equal(cells_k.view(torch.int32),
                                            cells_p.view(torch.int32))),
            "device_ms": graph_ms(lambda a, b, mv: wm.warp_obmc(
                a, b, mv, cells=True, **kw), sets, 100)}
        del sets

        def folded(a, b, mv):
            pr, cl = wm.warp_obmc(a, b, mv, cells=True, **kw)
            return wm.warp_epilogue(pr, a, b, 0.5, True, True,
                                    crop=(1080, 1920), cells=cl)
        both["cells folded into the warp"] = folded
    for label, fn in both.items():
        sets = smoke.operand_sets((a, b, mv), 5 * a.nbytes)
        res[f"4q warp + epilogue, {label}"] = {
            "device_ms": graph_ms(fn, sets, 100)}
        del sets
    pair = wm.warp_obmc(a, b, mv, block=8, search_radius=smoke.RADIUS,
                        dtype=torch.bfloat16, pair=True)
    if fold:
        cells = wm.fallback_cells_plain(pair, a, b)
        sets = smoke.operand_sets((pair, a, b, cells),
                                  pair.nbytes + 3 * a.nbytes)
        res["warp_epilogue occlusion + fallback, cells given"] = {
            "device_ms": graph_ms(
                lambda pr, x, y, cl: wm.warp_epilogue(
                    pr, x, y, 0.5, True, True, crop=(1080, 1920), cells=cl),
                sets, 100)}
        del sets
    occ = getattr(lib, "tpufg_warp_epilogue_occupancy", None)
    for label, (occlusion, fallback) in EPILOGUE_OPTIONS.items():
        def call(pr, x, y, o=occlusion, f=fallback):
            return wm.warp_epilogue(pr, x, y, 0.5, o, f, crop=(1080, 1920))
        k = call(pair, a, b)
        p = wm.warp_epilogue_plain(pair, a, b, 0.5, occlusion, fallback,
                                   (1080, 1920))
        sets = smoke.operand_sets((pair, a, b),
                                  pair.nbytes + 2 * a.nbytes + k.nbytes)
        res[f"warp_epilogue {label}"] = {
            "bitwise": bool(torch.equal(k.view(torch.int32),
                                        p.view(torch.int32))),
            "ms": time_ms(lambda: call(pair, a, b), 50),
            "device_ms": graph_ms(call, sets, 100)}
        del sets
    if occ is not None:
        res["warp_epilogue occupancy"] = {
            name: [occ(kernel, i) for i in range(3)]
            for name, kernel in (("cells", 0), ("blend", 1))}


def warp_bytes(a, mv, single: bool, out) -> int:
    """Bytes one warp call moves: the frames it reads, the MVs, the
    output."""
    return (1 if single else 2) * a.nbytes + mv.nbytes + out.nbytes


def inputs():
    """The chain's inputs and weights, the two searches' pairs and the
    Lanczos frames, made from a seed as chip_smoke.py makes them."""
    import numpy as np
    import torch
    from tpufg_torch.models import rife
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    head = rife.params_to_torch(rife.load_params(rife.bundled_checkpoint()),
                                dev)
    names = ("r_in", "r_body", "r_head")
    ws = tuple(head[n]["w"] for n in names)
    bs = tuple(head[n]["b"] for n in names)
    x17 = torch.from_numpy(rng.standard_normal((17, 540, 960)).astype(
        np.float32)).to(dev)
    chains = {"[17, 540, 960]": (x17, ws, bs),
              "[13, 540, 960]": (x17[:13].contiguous(),
                                 (ws[0][:, :13].contiguous(),) + ws[1:], bs)}

    def codes(shape):
        q = rng.integers(0, 256, shape).astype(np.float32)
        return torch.from_numpy(q * np.float32(1 / 255)).to(dev)

    def moved_pair(shape):
        prev = codes(shape)
        curr = torch.roll(prev, (3, -2), (1, 2))
        curr[:, :16] = codes((shape[0], 16, shape[2]))
        return prev, curr

    pairs = {key: moved_pair(key[0]) for key in TILED_SHAPES}
    sites = {shape: moved_pair(shape) for shape in SITES_SHAPES}
    frames = {(i, o): codes((4, *i)) for i, o in LANCZOS_SHAPES}
    return chains, pairs, sites, frames


def run_tree(only: str | None = None) -> dict:
    """Check and time the kernels of the tree in the working directory
    (``only="4q"``: config 4q's two warp kernels alone)."""
    import torch
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels.conv import (conv3x3_chain, conv3x3_chain_plain,
                                          conv3x3_s2, conv3x3_s2_plain)
    from tpufg_torch.kernels.lanczos import (lanczos_scale_fast,
                                             lanczos_scale_fast_plain,
                                             lanczos_scale_packed,
                                             lanczos_scale_packed_plain)
    from tpufg_torch.kernels.motion import (motion_search_sites,
                                            motion_search_sites_plain,
                                            motion_search_tiled,
                                            motion_search_tiled_plain)
    from tpufg_torch.kernels import warp_matmul as wm
    from tpufg_torch.kernels.warp import (warp_blend_block,
                                          warp_blend_block_plain)
    t0 = time.perf_counter()
    common.cuda_lib()
    res = {"card": card(), "build_s": time.perf_counter() - t0}
    run_4q(res)
    if only == "4q":
        return res
    block, engine = warp_inputs()
    for label, (a, b, mv, kw) in block.items():
        k = warp_blend_block(a, b, mv, **kw)
        p = warp_blend_block_plain(a, b, mv, **kw)
        sets = smoke.operand_sets((a, b, mv), warp_bytes(
            a, mv, kw.get("single", False), k))
        res[f"warp_block {list(a.shape)} {label}"] = {
            "bitwise": bool(torch.equal(k.view(torch.int32),
                                        p.view(torch.int32))),
            "ms": time_ms(lambda: warp_blend_block(a, b, mv, **kw), 100,
                          warmup=5),
            "device_ms": graph_ms(
                lambda a, b, mv: warp_blend_block(a, b, mv, **kw), sets,
                100)}
    # an earlier tree's warp_blend_matmul is plain torch and takes no crop:
    # it is timed with the crop copy the engine made after it
    plain = getattr(wm, "warp_blend_matmul_plain", None)
    for label, (a, b, mv, kw, crop) in engine.items():
        if plain is None:
            def call(a, b, mv):
                out = wm.warp_blend_matmul(a, b, mv, **kw)
                return out if crop is None else \
                    out[:, :crop[0], :crop[1]].contiguous()
        else:
            def call(a, b, mv):
                return wm.warp_blend_matmul(a, b, mv, crop=crop, **kw)
        entry = {"ms": time_ms(lambda: call(a, b, mv), 50 if plain else 10,
                               warmup=3)}
        if plain is not None:
            k = call(a, b, mv)
            sets = smoke.operand_sets((a, b, mv), warp_bytes(
                a, mv, kw.get("single", False), k))
            entry["device_ms"] = graph_ms(call, sets, 100)
            p = plain(a, b, mv, crop=crop, **kw)
            entry["bitwise"] = bool(torch.equal(k.view(torch.int32),
                                                p.view(torch.int32)))
        res[f"warp_matmul {label}"] = entry
    chains, pairs, sites, frames = inputs()
    planar, s2 = planar_inputs()
    for (c, (ih, iw), (oh, ow), dt), x in planar.items():
        k = lanczos_scale_fast(x, oh, ow)
        p = lanczos_scale_fast_plain(x, oh, ow)
        res[f"planar [{c},{ih},{iw}]->{oh}x{ow} {dt}"] = {
            "bitwise": bool(k.dtype == p.dtype and torch.equal(
                k.view(torch.int16), p.view(torch.int16))),
            "ms": time_ms(lambda: lanczos_scale_fast(x, oh, ow), 100,
                          warmup=5)}
    for (shape, cout, dt), (x, w, b, dtype) in s2.items():
        k = conv3x3_s2(x, w, b, compute_dtype=dtype)
        p = conv3x3_s2_plain(x, w, b, compute_dtype=dtype)
        res[f"s2 {list(shape)}->{cout} {dt}"] = {
            "max_rel_err": float((k - p).abs().max() / p.abs().max()),
            "ms": time_ms(lambda: conv3x3_s2(x, w, b, compute_dtype=dtype),
                          100, warmup=5)}
    for shape, (pr, cu) in sites.items():
        k = motion_search_sites(pr, cu, search_radius=SITES_RADIUS)
        p = motion_search_sites_plain(pr, cu, search_radius=SITES_RADIUS)
        res[f"sites {list(shape)} r={SITES_RADIUS}"] = {
            "bitwise": bool(torch.equal(k.view(torch.int32),
                                        p.view(torch.int32))),
            "ms": time_ms(lambda: motion_search_sites(
                pr, cu, search_radius=SITES_RADIUS), 20)}
    for ((ih, iw), (oh, ow)), x in frames.items():
        k = lanczos_scale_packed(x, oh, ow, raw_i32=True)
        p = lanczos_scale_packed_plain(x, oh, ow, raw_i32=True)
        res[f"lanczos {ih}x{iw}->{oh}x{ow}"] = {
            "bytes_differing": int((k.view(torch.uint8)
                                    != p.view(torch.uint8)).sum()),
            "ms": time_ms(lambda: lanczos_scale_packed(
                x, oh, ow, raw_i32=True), 100, warmup=5)}
    for label, (x, ws, bs) in chains.items():
        k = conv3x3_chain(x, ws, bs)
        p = conv3x3_chain_plain(x, ws, bs)
        res[f"chain {label} bf16"] = {
            "max_rel_err": float((k - p).abs().max() / p.abs().max()),
            "ms": time_ms(lambda: conv3x3_chain(x, ws, bs), 50),
            "plain_ms": time_ms(lambda: conv3x3_chain_plain(x, ws, bs), 20)}
    for (shape, b, r, exact), (pr, cu) in pairs.items():
        k = motion_search_tiled(pr, cu, block_size=b, search_radius=r,
                                exact_box=exact)
        p = motion_search_tiled_plain(pr, cu, b, r, exact_box=exact)
        res[f"tiled {list(shape)} b={b} r={r} exact_box={exact}"] = {
            "bitwise": bool(torch.equal(k.view(torch.int32),
                                        p.view(torch.int32))),
            "ms": time_ms(lambda: motion_search_tiled(
                pr, cu, block_size=b, search_radius=r, exact_box=exact), 5,
                warmup=1)}
    return res


def build_variant(source: str, defines: dict) -> ctypes.CDLL:
    """nvcc one csrc/ source alone, with -D overrides, into _build/."""
    from tpufg_torch.kernels import common
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "_".join(f"{k}{v}" for k, v in defines.items())
    so = common.BUILD_DIR / f"variant_{source}_{tag}.so"
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared",
           *(f"-D{k}={v}" for k, v in defines.items()), "-o", str(so),
           str(common.CSRC / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # ptxas -v: "Used N registers" and "... M bytes spill stores" per kernel
    report = proc.stdout + proc.stderr
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", report)]
    print(f"built {so.name}: most registers {max(regs, default=-1)}, "
          f"kernels that spill {sum(n > 0 for n in spills)}")
    return ctypes.CDLL(str(so))


def build_variants(jobs: list) -> list:
    """nvcc each (csrc/ source, dict of -D overrides) into _build/, eight
    compiles side by side; the loaded libraries, in order."""
    from tpufg_torch.kernels import common
    common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = []
    for i in range(0, len(jobs), 8):
        procs = []
        for source, defines in jobs[i:i + 8]:
            tag = "_".join(f"{k}{v}" for k, v in defines.items())
            so = common.BUILD_DIR / f"variant_{source}_{tag}.so"
            cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared",
                   *(f"-D{k}={v}" for k, v in defines.items()), "-o",
                   str(so), str(common.CSRC / f"{source}.cu")]
            procs.append((so, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for so, cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)}\n{out}")
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", out)]
            spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                                 out)]
            print(f"built {so.name}: most registers {max(regs, default=-1)},"
                  f" kernels that spill {sum(n > 0 for n in spills)}")
            libs.append(ctypes.CDLL(str(so)))
    return libs


def run_warp_variants() -> None:
    """Both block warps at each variant of the walk, against the built
    library's results; device times from CUDA graphs (graph_ms)."""
    import numpy as np
    import torch
    from tpufg_torch.kernels.warp import warp_blend_block
    from tpufg_torch.kernels.warp_matmul import warp_blend_matmul
    tag = f"[{card()}]"
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    block, engine = warp_inputs()
    keys = ("WARP_V", "WARP_RT", "WARP_ROWS", "WARP_NCH")
    variants = [dict(zip(keys, v)) for v in WARP_VARIANTS]
    libs = build_variants([(src, d) for d in variants
                           for src in ("warp_block", "warp_matmul")])
    for i, defines in enumerate(variants):
        name = " ".join(f"{k[5:]} {v}" for k, v in defines.items())
        fb = libs[2 * i].tpufg_warp_block
        fb.argtypes = [P] * 4 + [I] * 4 + [F, F, I, I, P]
        fb.restype = I
        fm = libs[2 * i + 1].tpufg_warp_matmul
        fm.argtypes = [P] * 4 + [I] * 4 + [F] * 3 + [I] * 9 + [P]
        fm.restype = I
        for label, (a, b, mv, kw) in block.items():
            ref = warp_blend_block(a, b, mv, **kw)
            t = float(kw.get("factor", 0.5))
            single = bool(kw.get("single", False))
            # each operand set writes its own output
            sets = smoke.operand_sets((a, b, mv, torch.empty_like(ref)),
                                      warp_bytes(a, mv, single, ref))

            def call(a, b, mv, out):
                rc = fb(a.data_ptr(), b.data_ptr(), mv.data_ptr(),
                        out.data_ptr(), *a.shape, 16, 16.0, t, int(single), 0,
                        torch.cuda.current_stream(0).cuda_stream)
                if rc:
                    raise RuntimeError(f"warp_block variant: CUDA error {rc}")
            ms = graph_ms(call, sets, 100)
            same = bool(torch.equal(sets[0][3].view(torch.int32),
                                    ref.view(torch.int32)))
            print(f"warp_block {list(a.shape)} {label} {name}: {ms:.4f} ms, "
                  f"bitwise to the library's {same} {tag}")
        for label, (a, b, mv, kw, crop) in engine.items():
            ref = warp_blend_matmul(a, b, mv, crop=crop, **kw)
            t = float(np.float32(kw.get("factor", 0.5)))
            omt = float(np.float32(1.0) - np.float32(kw.get("factor", 0.5)))
            integer = bool(kw.get("integer_offsets", False))
            single = bool(kw.get("single", False))
            sets = smoke.operand_sets((a, b, mv, torch.empty_like(ref)),
                                      warp_bytes(a, mv, single, ref))

            def call(a, b, mv, out):
                rc = fm(a.data_ptr(), b.data_ptr(), mv.data_ptr(),
                        out.data_ptr(), *a.shape, kw["block"],
                        float(kw["search_radius"]), t, omt, *ref.shape[1:],
                        int(single), int(integer),
                        int(integer and kw.get("u8_exact", False)),
                        int(kw["dtype"] == torch.bfloat16), 0, a.shape[2],
                        0, torch.cuda.current_stream(0).cuda_stream)
                if rc:
                    raise RuntimeError(f"warp_matmul variant: CUDA error {rc}")
            ms = graph_ms(call, sets, 100)
            same = bool(torch.equal(sets[0][3].view(torch.int32),
                                    ref.view(torch.int32)))
            print(f"warp_matmul {label} {list(a.shape)} {name}: {ms:.4f} ms, "
                  f"bitwise to the library's {same} {tag}")


def run_obmc_variants() -> None:
    """warp_obmc at each variant of its walk (csrc/warp_obmc.cu's knobs),
    pair, blend and single mode in bf16 at config 4q's shape, against the
    built library's results; device times from CUDA graphs (graph_ms)."""
    import numpy as np
    import torch
    from tpufg_torch.kernels.resize import linear_taps
    from tpufg_torch.kernels.warp_matmul import warp_obmc
    tag = f"[{card()}]"
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    a, b, mv_rand = q4_inputs()
    _, h, w = a.shape
    tx, ty = linear_taps(w // 8, w, a.device), linear_taps(h // 8, h, a.device)
    keys = ("OBMC_V", "OBMC_RT", "OBMC_ROWS", "OBMC_NCH")
    variants = [dict(zip(keys, v)) for v in OBMC_VARIANTS]
    libs = build_variants([("warp_obmc", d) for d in variants])
    for defines, lib in zip(variants, libs):
        name = " ".join(f"{k[5:]} {v}" for k, v in defines.items())
        fn = lib.tpufg_warp_obmc
        fn.argtypes = [P] * 11 + [I] * 5 + [F] * 3 + [I] * 5 + [P]
        fn.restype = I
        occ = lib.tpufg_warp_obmc_occupancy
        occ.argtypes, occ.restype = [I] * 4, I
        modes = dict(OBMC_MODES, pan=OBMC_MODES["pair"],
                     cells=(dict(pair=True, cells=True), 10))
        for mode, (kw, _) in modes.items():
            kw = dict(kw, block=8, search_radius=smoke.RADIUS,
                      dtype=torch.bfloat16)
            mv = pan_mvs(mv_rand) if mode == "pan" else mv_rand
            ref = warp_obmc(a, b, mv, **kw)
            ref_cells = ref[1] if mode == "cells" else ref[:2, :8, :8]
            ref = ref[0] if mode == "cells" else ref
            m = {"pair": 2, "pan": 2, "cells": 3, "blend": 1,
                 "single": 0}[mode]
            sets = smoke.operand_sets(
                (a, b, mv, torch.empty_like(ref), torch.empty_like(ref_cells)),
                (1 if m == 0 else 2) * a.nbytes + mv.nbytes + ref.nbytes)
            t = float(np.float32(0.5))

            def call(a, b, mv, out, cells, m=m):
                rc = fn(a.data_ptr(), b.data_ptr(), mv.data_ptr(),
                        tx.i0_i32.data_ptr(), tx.w0.data_ptr(),
                        tx.w1.data_ptr(), ty.i0_i32.data_ptr(),
                        ty.w0.data_ptr(), ty.w1.data_ptr(), out.data_ptr(),
                        cells.data_ptr(), 4, h, w, 8, w,
                        float(smoke.RADIUS), t, t, *ref.shape[1:], m, 1, 0,
                        torch.cuda.current_stream(0).cuda_stream)
                if rc:
                    raise RuntimeError(f"warp_obmc variant: CUDA error {rc}")
            ms = graph_ms(call, sets, 100)
            same = bool(torch.equal(sets[0][3].view(torch.int32),
                                    ref.view(torch.int32))) and (
                m != 3 or bool(torch.equal(sets[0][4].view(torch.int32),
                                           ref_cells.view(torch.int32))))
            regs, per_sm, spill = (occ(m, 1, 4, i) for i in range(3))
            print(f"warp_obmc {mode} {name}: {ms:.4f} ms on the device, "
                  f"{regs} registers, {spill} bytes spilled, {per_sm} "
                  f"blocks per SM, bitwise to the library's {same} {tag}")
            del sets


def run_variants(which: tuple) -> None:
    import torch
    from tpufg_torch.kernels import common
    from tpufg_torch.kernels.conv import (_CHAIN_TILE, chain_mma_layout,
                                          conv3x3_chain,
                                          packed_chain_weights)
    from tpufg_torch.kernels import lanczos as lz
    from tpufg_torch.kernels.lanczos import lanczos_scale_packed
    from tpufg_torch.kernels.motion import (_MAX_SMEM, motion_search_sites,
                                            motion_search_tiled,
                                            sites_smem_bytes,
                                            tiled_smem_bytes)
    if "obmc" in which:
        run_obmc_variants()
        if which == ("obmc",):
            return
    if "warp" in which:
        run_warp_variants()
        if which == ("warp",):
            return
    tag = f"[{card()}]"
    chains, pairs, sites, frames = inputs()
    stream = torch.cuda.current_stream(0).cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    # the sites search: dy candidates scored together (and per barrier)
    for dy_block in (1, 2, 3, 4, 5, 6, 8) if "sites" in which else ():
        lib = build_variant("motion_sites", {"SITES_DY_BLOCK": dy_block})
        fn = lib.tpufg_motion_sites
        fn.argtypes = [P] * 3 + [I] * 7 + [P]
        fn.restype = I
        for shape, (pr, cu) in sites.items():
            ref = motion_search_sites(pr, cu, search_radius=SITES_RADIUS)
            out = torch.empty_like(ref)
            smem = sites_smem_bytes(SITES_RADIUS, dy_block)

            def call():
                rc = fn(pr.data_ptr(), cu.data_ptr(), out.data_ptr(),
                        shape[0], shape[1], shape[2], SITES_RADIUS, dy_block,
                        smem, 0, stream)
                if rc:
                    raise RuntimeError(f"sites variant: CUDA error {rc}")
            ms = time_ms(call, 20)
            same = bool(torch.equal(out.view(torch.int32),
                                    ref.view(torch.int32)))
            print(f"sites {list(shape)} r={SITES_RADIUS} dy block {dy_block} "
                  f"smem {smem}: {ms:.4f} ms, bitwise to the library's "
                  f"{same} {tag}")

    # the packed Lanczos: tile columns (compiled in) x tile rows, and the
    # direct stencil (tile rows 0)
    for tile_w in (64, 128, 256) if "lanczos" in which else ():
        lib = build_variant("lanczos_packed", {"LANCZOS_TILE_W": tile_w})
        fn = lib.tpufg_lanczos_packed
        fn.argtypes = [P] * 8 + [I] * 11 + [P]
        fn.restype = I
        for ((ih, iw), (oh, ow)), x in frames.items():
            ref = lanczos_scale_packed(x, oh, ow, raw_i32=True)
            dev = x.device
            ix, wx = lz._device_taps(iw, ow, 3, dev)
            iy, wy = lz._device_taps(ih, oh, 3, dev)
            sx = lz._device_starts(iw, ow, 3, dev)
            sy = lz._device_starts(ih, oh, 3, dev)
            for rows in (0, 4, 8, 16, 32, 64):
                if rows == 0:
                    if tile_w != 128:
                        continue    # the direct stencil has no tile width
                    plan = lz.LanczosPlan(tile_w, 0, 0, 0, 0)
                else:
                    plan = lz.lanczos_plan(ih, iw, oh, ow, 3, tile_w=tile_w,
                                           tile_rows=rows)
                if plan.smem > _MAX_SMEM:
                    continue
                out = torch.empty_like(ref)

                def call():
                    rc = fn(x.data_ptr(), iy.data_ptr(), wy.data_ptr(),
                            ix.data_ptr(), wx.data_ptr(), sy.data_ptr(),
                            sx.data_ptr(), out.data_ptr(), ih, iw, oh, ow, 6,
                            *plan, 0, stream)
                    if rc:
                        raise RuntimeError(f"lanczos variant: CUDA error {rc}")
                ms = time_ms(call, 100, warmup=5)
                same = bool(torch.equal(out, ref))
                print(f"lanczos {ih}x{iw}->{oh}x{ow} tile {tile_w} x {rows} "
                      f"smem {plan.smem}: {ms:.4f} ms, equal to the "
                      f"library's {same} {tag}")

    # the planar Lanczos: tile rows x channels per block (launch arguments
    # of the built library), and the direct stencil (tile rows 0)
    if "planar" in which:
        from tpufg_torch.kernels.lanczos import lanczos_scale_fast
        fn = common.cuda_lib().tpufg_lanczos_planar
        planar, _ = planar_inputs(PLANAR_SHAPES + PLANAR_DOWNSCALES)
        for (c, (ih, iw), (oh, ow), dt), x in planar.items():
            ref = lanczos_scale_fast(x, oh, ow)
            print(f"planar [{c},{ih},{iw}]->{oh}x{ow} {dt}: the plan is "
                  f"{lz.planar_plan(c, ih, iw, oh, ow, 3)}")
            dev = x.device
            ix, wx = lz._device_taps(iw, ow, 3, dev)
            iy, wy = lz._device_taps(ih, oh, 3, dev)
            sx = lz._device_starts(iw, ow, 3, dev)
            sy = lz._device_starts(ih, oh, 3, dev)
            for rows in (0, 4, 8, 16, 32, 64):
                for group in (1, 2, 3, 4) if rows else (1,):
                    if group > c:
                        continue
                    if rows == 0:
                        plan = lz.LanczosPlan(128, 0, 0, 0, 0)
                        work = [(0, c, 1)]
                    else:
                        plan = lz.lanczos_plan(ih, iw, oh, ow, 3,
                                               tile_rows=rows, n_ch=group)
                        work = lz.channel_groups(c, group)
                    if plan.smem > _MAX_SMEM:
                        continue
                    out = torch.empty_like(ref)

                    def call():
                        for first, blocks, nch in work:
                            rc = fn(x[first].data_ptr(), iy.data_ptr(),
                                    wy.data_ptr(), ix.data_ptr(),
                                    wx.data_ptr(), sy.data_ptr(),
                                    sx.data_ptr(), out[first].data_ptr(),
                                    blocks, nch, ih, iw, oh, ow, 6,
                                    int(dt == "bf16"), plan.tile_w,
                                    plan.tile_rows, plan.rows_cap,
                                    plan.cols_cap,
                                    lz.tile_smem_bytes(plan, 6, nch), 0,
                                    stream)
                            if rc:
                                raise RuntimeError(
                                    f"planar variant: CUDA error {rc}")
                    ms = time_ms(call, 100, warmup=5)
                    same = bool(torch.equal(out.view(torch.int16),
                                            ref.view(torch.int16)))
                    staged = (plan.rows_cap * 4 * plan.cols_cap
                              / max(rows * plan.tile_w, 1))
                    print(f"planar [{c},{ih},{iw}]->{oh}x{ow} {dt} tile rows "
                          f"{rows} channels per block {group} smem "
                          f"{plan.smem} staged per pixel {staged:.1f}: "
                          f"{ms:.4f} ms, bitwise to the library's {same} "
                          f"{tag}")

        # the plan's launches with plain stores in place of streaming ones
        # (a rebuild)
        lib = build_variant("lanczos_planar", {"PLANAR_STORE_CS": 0})
        fn = lib.tpufg_lanczos_planar
        fn.argtypes = [P] * 8 + [I] * 14 + [P]
        fn.restype = I
        for (c, (ih, iw), (oh, ow), dt), x in planar.items():
            group, plan = lz.planar_plan(c, ih, iw, oh, ow, 3)
            if plan.tile_rows == 0:
                continue
            ref = lanczos_scale_fast(x, oh, ow)
            out = torch.empty_like(ref)
            dev = x.device
            ix, wx = lz._device_taps(iw, ow, 3, dev)
            iy, wy = lz._device_taps(ih, oh, 3, dev)
            sx = lz._device_starts(iw, ow, 3, dev)
            sy = lz._device_starts(ih, oh, 3, dev)

            def call():
                for first, blocks, nch in lz.channel_groups(c, group):
                    rc = fn(x[first].data_ptr(), iy.data_ptr(), wy.data_ptr(),
                            ix.data_ptr(), wx.data_ptr(), sy.data_ptr(),
                            sx.data_ptr(), out[first].data_ptr(), blocks,
                            nch, ih, iw, oh, ow, 6, int(dt == "bf16"),
                            plan.tile_w, plan.tile_rows, plan.rows_cap,
                            plan.cols_cap, lz.tile_smem_bytes(plan, 6, nch),
                            0, stream)
                    if rc:
                        raise RuntimeError(f"planar variant: CUDA error {rc}")
            ms = time_ms(call, 100, warmup=5)
            lib_ms = time_ms(lambda: lanczos_scale_fast(x, oh, ow), 100,
                             warmup=5)
            same = bool(torch.equal(out.view(torch.int16),
                                    ref.view(torch.int16)))
            print(f"planar [{c},{ih},{iw}]->{oh}x{ow} {dt} plain stores: "
                  f"{ms:.4f} ms (the library's {lib_ms:.4f}), bitwise to the "
                  f"library's {same} {tag}")

    # the bf16 stride-2 conv: tile rows x columns and the two epilogues
    if "s2" in which:
        from tpufg_torch.kernels.conv import conv3x3_s2, packed_s2_weights
        _, s2 = planar_inputs()
        for rows, cols in ((8, 64), (4, 64), (16, 64), (8, 32), (8, 128),
                           (4, 128)):
            for epilogue in (0, 1):
                lib = build_variant("conv_s2_mma", {"S2_TILE_ROWS": rows,
                                                    "S2_TILE_COLS": cols,
                                                    "S2_EPILOGUE": epilogue})
                fn = lib.tpufg_conv_s2_bf16
                fn.argtypes = [P] * 4 + [I] * 5 + [P]
                fn.restype = I
                for (shape, cout, dt), (x, w, b, dtype) in s2.items():
                    if dt != "bf16":
                        continue
                    ref = conv3x3_s2(x, w, b, compute_dtype=dtype)
                    wt, bp = packed_s2_weights(w, b, dtype)
                    out = torch.empty_like(ref)

                    def call():
                        rc = fn(x.data_ptr(), wt.data_ptr(), bp.data_ptr(),
                                out.data_ptr(), shape[0], cout, shape[1],
                                shape[2], 0, stream)
                        if rc:
                            raise RuntimeError(f"s2 variant: CUDA error {rc}")
                    ms = time_ms(call, 100, warmup=5)
                    d = float((out - ref).abs().max() / ref.abs().max())
                    print(f"s2 {list(shape)}->{cout} bf16 tile {rows} x "
                          f"{cols} epilogue {epilogue}: {ms:.4f} ms, max "
                          f"|d| / max |library's| {d:.3e} {tag}")

    # the tiled search: rows per tile x groups per block, separable and exact
    for key in (TILED_SHAPES[0], TILED_SHAPES[2]) if "tiled" in which else ():
        shape, b, r, exact = key
        pr, cu = pairs[key]
        ref = motion_search_tiled(pr, cu, block_size=b, search_radius=r,
                                  exact_box=exact)
        # the launch bound (128 threads x the most groups) caps the
        # registers, so 4 groups are also timed in a build that allows no
        # more; the merge at the end has room for 5 groups
        for rows, most, some in ((8, 5, range(1, 6)), (16, 5, range(1, 6)),
                                 (16, 4, (4,))):
            lib = build_variant("motion_tiled", {"TILED_ROWS": rows,
                                                 "TILED_MAX_GROUPS": most})
            fn = lib.tpufg_motion_tiled
            fn.argtypes = [P] * 3 + [I] * 10 + [P]
            fn.restype = I
            for groups in some:
                smem = tiled_smem_bytes(b, r, exact, rows, groups)
                if smem > _MAX_SMEM:
                    continue
                out = torch.empty((2,) + shape[1:], device=pr.device)

                def call():
                    rc = fn(pr.data_ptr(), cu.data_ptr(), out.data_ptr(),
                            shape[0], shape[1], shape[2], b, r, int(exact),
                            rows, groups, smem, 0, stream)
                    if rc:
                        raise RuntimeError(f"tiled variant: CUDA error {rc}")
                ms = time_ms(call, 3, warmup=1)
                same = bool(torch.equal(out.view(torch.int32),
                                        ref.view(torch.int32)))
                print(f"tiled {list(shape)} b={b} r={r} exact_box={exact} "
                      f"rows {rows} groups {groups} smem {smem}: {ms:.4f} ms,"
                      f" bitwise to the library's {same} {tag}")

    # the chain: warps per block x m16 tiles per warp x taps unrolled
    if "chain" not in which:
        return
    x, ws, bs = chains["[17, 540, 960]"]
    ref = conv3x3_chain(x, ws, bs)
    wts, bias = packed_chain_weights(ws, bs, torch.bfloat16)
    th, tw = _CHAIN_TILE[torch.bfloat16]
    off, w_off, smem = chain_mma_layout([17, 64, 64, 5], (th, tw))
    for warps, mt, taps in ((16, 2, 3), (16, 2, 1), (16, 2, 9), (16, 1, 3),
                            (12, 2, 3), (12, 3, 3), (8, 4, 3), (8, 2, 3),
                            (4, 4, 3)):
        lib = build_variant("conv_chain_mma", {"CHAIN_WARPS": warps,
                                               "CHAIN_MT": mt,
                                               "CHAIN_TAP_UNROLL": taps})
        fn = lib.tpufg_conv_chain_bf16
        fn.argtypes = [P] * 4 + [I] * 14 + [P]
        fn.restype = I
        out = torch.empty_like(ref)

        def call():
            rc = fn(x.data_ptr(), out.data_ptr(), wts.data_ptr(),
                    bias.data_ptr(), 3, 17, 64, 64, 5, 3, 540, 960, th, tw,
                    off, w_off, smem, 0, stream)
            if rc:
                raise RuntimeError(f"chain variant: CUDA error {rc}")
        ms = time_ms(call, 50)
        d = float((out - ref).abs().max() / ref.abs().max())
        print(f"chain [17, 540, 960] bf16 warps {warps} m16 tiles per warp "
              f"{mt} taps unrolled {taps}: {ms:.4f} ms, max |d| / max |library's| {d:.3e} {tag}")


def run_parent(parent: str, only: str | None) -> None:
    me = os.path.abspath(__file__)
    extra = ["--only", only] if only else []
    for label, cwd in (("parent", parent), ("change", "."), ("change", "."),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, me, *extra], cwd=cwd,
                             check=True, capture_output=True, text=True)
        print(label, out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="?", const="all",
                    choices=("all", "chain", "tiled", "sites", "lanczos",
                             "planar", "s2", "warp", "obmc"))
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--only", choices=("4q",),
                    help="time config 4q's two warp kernels alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.parent:
        run_parent(args.parent, args.only)
    elif args.variants:
        run_variants(("obmc", "warp", "sites", "lanczos", "planar", "s2",
                      "chain", "tiled")
                     if args.variants == "all" else (args.variants,))
    else:
        print(json.dumps(run_tree(args.only)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
