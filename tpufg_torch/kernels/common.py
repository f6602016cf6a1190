"""Shared helpers of the port's kernels: integer math, the nvcc build and
ctypes loader, and the tensor checks every wrapper runs.

Counterpart of ``tpufg/kernels/common.py``.  The CUDA sources live in
``tpufg_torch/csrc/``.  Each is compiled by its own nvcc process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds),
written to ``tpufg_torch/_build/`` under a name that hashes the sources
and flags: an unchanged tree reuses the library, an edited source
rebuilds it.  The build runs on the first kernel call on a
CUDA tensor, never at import, so the package imports on machines without
a GPU or a CUDA toolkit.

Every wrapper follows one rule (:func:`use_plain`): a CPU tensor, or any
tensor inside :func:`plain_versions`, takes the plain PyTorch version;
otherwise a CUDA tensor launches the kernel or raises.  Nothing falls back
silently.  Each wrapper keeps a plain integer
``launches`` attribute that it increments once per kernel launch
(:func:`counted_wrappers` finds them).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Iterator

import torch

from tpufg_torch.utils.tracing import nan_guard_active

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # ptxas prints registers / spills per kernel into the build log
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C signature of every launcher in csrc/: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), ints as c_int
# (an element count past 2**31 as c_int64), floats as c_float
_SIGNATURES = {
    # (src i32 [h,w], dst f32 [4,h,w], h, w, device, stream)
    "tpufg_unpack": (_P, _P, _I, _I, _I, _P),
    # (src f32 [c,h,w], dst f32 [c,h/2,w/2], c, h, w, device, stream)
    "tpufg_box2": (_P, _P, _I, _I, _I, _I, _P),
    # (img f32 [4,ih,iw], idx_y, w_y, idx_x, w_x, start_y, start_x,
    #  out i32 [oh,ow], ih, iw, oh, ow, taps, tile columns, tile rows (0:
    #  the direct stencil), staged rows, staged columns, smem bytes, device,
    #  stream)
    "tpufg_lanczos_packed": (_P,) * 8 + (_I,) * 11 + (_P,),
    # (img f32|bf16 [groups*nch,ih,iw], idx_y, w_y, idx_x, w_x, start_y,
    #  start_x, out [groups*nch,oh,ow] of img's type, channel groups,
    #  channels per group, ih, iw, oh, ow, taps, bf16, tile columns, tile
    #  rows (0: the direct stencil), staged rows, staged columns, smem
    #  bytes, device, stream)
    "tpufg_lanczos_planar": (_P,) * 8 + (_I,) * 14 + (_P,),
    # (prev f32 [c,h,w], curr, out f32 [2,h/16,w], c, h, w, r, dy candidates
    #  scored together, smem bytes, device, stream)
    "tpufg_motion_sites": (_P,) * 3 + (_I,) * 7 + (_P,),
    # (prev f32 [c,h,w], curr, out f32 [2,h,w], c, h, w, b, r, exact_box,
    #  output rows per tile, 128-thread groups per block, smem bytes,
    #  device, stream)
    "tpufg_motion_tiled": (_P,) * 3 + (_I,) * 10 + (_P,),
    # the f32 stride-2 conv: (x f32 [cin,h,w], wt f32 [cin*9,32], b f32
    #  [32], out f32 [cout,h/2,w/2], cin, cout, h, w, device, stream)
    "tpufg_conv_s2": (_P,) * 4 + (_I,) * 5 + (_P,),
    # the bf16 stride-2 conv: (x f32 [cin,h,w], the bf16 weights in mma
    #  B-fragment order, b f32 [32], out f32 [cout,h/2,w/2], cin, cout, h,
    #  w, device, stream)
    "tpufg_conv_s2_bf16": (_P,) * 4 + (_I,) * 5 + (_P,),
    # the f32 chain: (x f32 [c0,h,w], out f32 [cL,h,w], w0, b0, w1, b1, w2,
    #  b2 (null past the last layer), n_layers, c0, c1, c2, c3, relu mask,
    #  h, w, tile rows, tile cols, second buffer offset, smem bytes, device,
    #  stream)
    "tpufg_conv_chain": (_P,) * 8 + (_I,) * 13 + (_P,),
    # the bf16 chain: (x f32 [c0,h,w], out f32 [cL,h,w], every layer's bf16
    #  weights in mma B-fragment order, every layer's padded f32 bias,
    #  n_layers, c0, c1, c2, c3, relu mask, h, w, tile rows, tile cols,
    #  second buffer offset, weights offset, smem bytes, device, stream)
    "tpufg_conv_chain_bf16": (_P,) * 4 + (_I,) * 14 + (_P,),
    # (prev f32 [c,h,w], curr, mv f32 [2,h/g,w/g], out f32 [c,h,w], c, h,
    #  w, g, r, t, single, device, stream)
    "tpufg_warp_block": (_P,) * 4 + (_I,) * 4 + (_F, _F, _I, _I, _P),
    # (prev f32 [c,h,w], curr, mv f32 [2,h/g,w/g], out f32 [c,out_h,out_w]
    #  (pair: [2c+2,h,w]), c, h, w, g, r, t, 1 - t, out_h, out_w, single,
    #  integer offsets, u8 (the integer-code domain), bf16 (the moving
    #  type), pair, the masks' right edge, device, stream)
    "tpufg_warp_matmul": (_P,) * 4 + (_I,) * 4 + (_F,) * 3 + (_I,) * 9
    + (_P,),
    # (prev f32 [c,h,w], curr, mv f32 [2,h/g,w/g], the offsets' column
    #  taps of w/g -> w (i0 i32 [w], w0 f32 [w], w1 f32 [w]), the masks'
    #  row taps of h/g -> h (i0, w0, w1 [h]), out, the cell means out f32
    #  [2,h/8,w/8] (mode 3) or null, c, h, w, g, valid_w, r, t, 1 - t,
    #  out_h, out_w, mode (0 single, 1 blend, 2 pair, 3 pair and cells),
    #  bf16, device, stream)
    "tpufg_warp_obmc": (_P,) * 11 + (_I,) * 5 + (_F,) * 3 + (_I,) * 5
    + (_P,),
    # (pair f32 [2c+2,h,w], prev f32 [c,h,w], curr, cells out f32
    #  [2,h/8,w/8], c, h, w, device, stream)
    "tpufg_warp_fallback_cells": (_P,) * 4 + (_I,) * 4 + (_P,),
    # (pair, prev, curr, cells, the cells' row taps (i0, w0, w1) and column
    #  taps, out f32 [c,out_h,out_w], c, h, w, t, 1 - t, out_h, out_w,
    #  occlusion, fallback (0 off, 1 per pixel, 2 by cells), pick prev,
    #  device, stream)
    "tpufg_warp_epilogue": (_P,) * 11 + (_I,) * 3 + (_F,) * 2 + (_I,) * 6
    + (_P,),
    # (src i32 [h,w], out u8 payload, h, w, c420, vec (16-byte loads),
    #  device, stream)
    "tpufg_yuv": (_P, _P) + (_I,) * 5 + (_P,),
    # the exact path's scale: (img f32 [ih,iw,4], iy i32 [oh,taps], wy f32,
    #  vy u8, ix i32 [ow,taps], wx, vx, out u8 [oh,ow,4], ih, iw, oh, ow,
    #  taps, device, stream)
    "tpufg_oracle_scale": (_P,) * 8 + (_I,) * 6 + (_P,),
    # the exact path's warp: (prev f32 [h,w,4], curr, mv f32 [h,w,2] or
    #  null, u f32 [w], v f32 [h], x f32 [w], y f32 [h], out f32 [h,w,4], h,
    #  w, t, 1 - t, kx0, kx1, ky0, ky1, fuse_x, fuse_y, device, stream)
    "tpufg_oracle_warp": (_P,) * 8 + (_I,) * 2 + (_F,) * 6 + (_I,) * 3
    + (_P,),
    # the IFNet's bias and PReLU: (y bf16 channels-last, bias bf16 [c],
    #  slope bf16 [c], elements, c, out (null: in place) and its pixel
    #  stride, out2 (null: none) and its pixel stride, device, stream)
    "tpufg_bias_prelu": (_P,) * 3 + (_L, _I, _P, _L, _P, _L, _I, _P),
    # the IFNet's warp of f32 frames: (src, its batch, channel and row
    #  strides, flow f32 [n,2,h,w], its strides, base_x f32 [w], base_y f32
    #  [h], out f32, its strides, n, channels, h, w, the flow's x and y
    #  multipliers, device, stream)
    "tpufg_warp_grid_f32": (_P,) + (_L,) * 3 + (_P,) + (_L,) * 3
    + (_P,) * 3 + (_L,) * 3 + (_I,) * 4 + (_F,) * 2 + (_I, _P),
    # of channels-last bf16 features: (src, its row stride, flow, its
    #  channel and row strides, base_x, base_y, out (at its channel
    #  offset), its row and pixel strides, channels, h, w, the multipliers,
    #  device, stream)
    "tpufg_warp_grid_bf16": (_P, _L, _P, _L, _L, _P, _P, _P, _L, _L)
    + (_I,) * 3 + (_F,) * 2 + (_I, _P),
    # (the planes' pointers and row strides as int64 host arrays, planes,
    #  s2d, out bf16 channels-last, channels, h, w, device, stream)
    "tpufg_pack_nhwc": (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P),
    # (warped f32 [2,4,hp,wp], its batch, channel and row strides, sig f32,
    #  its row stride, u bf16 channels-last (space-to-depth), its channels,
    #  its row stride, out f32 [4,h,w], h, w, device, stream)
    "tpufg_ifnet_merge": (_P, _L, _L, _L, _P, _L, _P, _I, _L, _P, _I, _I, _I,
                          _P),
    # (t bf16 channels-last, its channels, th, tw, state f32 [1,5,h,w], h,
    #  w, 1 / (2S), 2S, first, device, stream)
    "tpufg_ifnet_accum": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _I, _I, _P),
    # RAFT's lookup: (the 4 levels' map pointers, their heights and widths
    #  as int32 arrays, their x and y multipliers as float arrays, coords
    #  f32 [2, n], n, out bf16 [n, out_c], out_c, device, stream)
    "tpufg_corr_lookup": (_P,) * 6 + (_L, _P, _I, _I, _P),
    # RAFT's convex upsampling: (flow f32 [2,h,w], mask bf16 [h,w,576], out
    #  f32 [2,8h,8w], h, w, device, stream)
    "tpufg_convex_upsample": (_P, _P, _P, _I, _I, _I, _P),
    # RAFT's correlation pyramid: (level 0 f32 [n,h,w], n, h, w, levels 1-3
    #  f32, device, stream)
    "tpufg_corr_pool": (_P, _L, _I, _I, _P, _P, _P, _I, _P),
    # RAFT's GRU gates: (zr bf16 [n, 256], its bias bf16 [256], h f32
    #  [n, 128], n, out bf16 (rows of stride os), os, device, stream)
    "tpufg_raft_gru_gates": (_P, _P, _P, _L, _P, _L, _I, _P),
    # RAFT's GRU update: (zr, its bias, q bf16 [n, 128], its bias bf16
    #  [128], h f32 [n, 128], n, out, os, copy bf16 [n, 128] or null,
    #  device, stream)
    "tpufg_raft_gru_update": (_P, _P, _P, _P, _P, _L, _P, _L, _P, _I, _P),
}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device a step or engine runs on: CUDA unless the caller names
    another one.  Raises when CUDA is asked for (explicitly or by default)
    and none is available — the port never moves to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpufg_torch needs a CUDA device and none is available "
                "(torch.cuda.is_available() is False); pass "
                "device=torch.device('cpu') explicitly to run the plain "
                "PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"tpufg_torch runs on cuda or cpu, got {device}")
    return device


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the tpufg_torch CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtpufg_torch_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library unless it is current: one
    nvcc per source, run in parallel, then one link.

    Raises RuntimeError with nvcc's output if a step fails.  ptxas's
    per-kernel report is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    t0 = time.perf_counter()
    log, failed = [], []
    for cmd, _, proc in jobs:          # wait for every compile
        out, _ = proc.communicate()
        log.append(out)
        # the compiles run side by side: a source's seconds are an upper
        # bound, exact for the one that takes longest
        log.append(f"{cmd[-1]}: done {time.perf_counter() - t0:.1f} s after "
                   "the start of the build\n")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build_library()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    # occupancy queries of the kernels whose launch is planned on the host:
    # (channels or taps, smem bytes) or, for the planar Lanczos, (taps,
    # channels per group, bf16, smem bytes) -> blocks per SM, -1 on error
    # the two 4q warp kernels: (mode, bf16, channels, what) and (0 the
    # cells pass or 1 the blend, what) -> what 0 registers a thread, 1
    # blocks per SM, 2 local memory bytes a thread (spills); the y4m
    # egress: (c420, vec, what) and the exact path's two kernels: (what),
    # the same whats
    for name, n_args in (("tpufg_motion_sites_blocks_per_sm", 2),
                         ("tpufg_lanczos_packed_blocks_per_sm", 2),
                         ("tpufg_lanczos_planar_blocks_per_sm", 4),
                         ("tpufg_warp_obmc_occupancy", 4),
                         ("tpufg_warp_epilogue_occupancy", 2),
                         ("tpufg_yuv_occupancy", 3),
                         ("tpufg_oracle_scale_occupancy", 1),
                         ("tpufg_oracle_warp_occupancy", 1)):
        fn = getattr(lib, name)
        fn.argtypes = [_I] * n_args
        fn.restype = ctypes.c_int
    lib.tpufg_error_string.argtypes = [ctypes.c_int]
    lib.tpufg_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, x: torch.Tensor, *args,
           out: tuple[torch.Tensor, ...] = ()) -> None:
    """Call launcher ``name`` on ``x``'s device and current stream; raise
    if CUDA refused the launch.  ``out``: the tensors the kernel writes,
    checked for NaN inside ``utils.tracing.debug_checks(True)`` (which
    synchronises): a launch bypasses the dispatcher that checks torch's
    own ops there."""
    lib = cuda_lib()
    dev = x.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(*args, dev, stream)
    if rc != 0:
        msg = lib.tpufg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    if nan_guard_active():
        for o in out:
            if o.is_floating_point() and bool(torch.isnan(o).any()):
                raise FloatingPointError(f"{name}: NaN in its output")


_PLAIN = contextvars.ContextVar("tpufg_torch_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Every kernel wrapper called in scope takes its plain PyTorch version
    on a CUDA tensor too, so that a run on the card can be held to its
    plain path.  The switch is a context variable, set on entry and reset
    by its token on exit: nesting and an exception restore it, and no other
    thread sees it.  Off by default; neither the engine nor the CLI enters
    it."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def in_plain_versions() -> bool:
    """Whether the caller runs inside :func:`plain_versions`, whatever the
    device (the one reading of the switch)."""
    return _PLAIN.get()


def use_plain(x: torch.Tensor) -> bool:
    """True for a CPU tensor, or a CUDA one inside :func:`plain_versions`
    (the plain path); False for a CUDA tensor otherwise (the kernel path);
    any other device is refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return in_plain_versions()
    raise ValueError(f"tpufg_torch kernels run on cpu or cuda, got {x.device}")


def counted_wrappers() -> list:
    """The kernel wrappers of the ``tpufg_torch.kernels`` modules imported
    so far: each function there with an integer ``launches`` count, once."""
    found = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith(__package__ + "."):
            continue
        for fn in vars(mod).values():
            if callable(fn) and type(getattr(fn, "launches", None)) is int:
                found[id(fn)] = fn
    return list(found.values())


def check_kernel_input(x: torch.Tensor, name: str, dtype: torch.dtype,
                       ndim: int) -> None:
    """Validate a CUDA kernel operand before its pointer is passed on."""
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {x.numel()} elements exceed int32 indexing")
