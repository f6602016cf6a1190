"""Shared helpers of the port's kernels: integer math, the nvcc build and
ctypes loader, and the tensor checks every wrapper runs.

Counterpart of ``tpufg/kernels/common.py``.  The CUDA sources live in
``tpufg_torch/csrc/``.  They are compiled by one nvcc command into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), written to ``tpufg_torch/_build/`` under a name that
hashes the sources and flags: an unchanged tree reuses the library, an
edited source rebuilds it.  The build runs on the first kernel call on a
CUDA tensor, never at import, so the package imports on machines without
a GPU or a CUDA toolkit.

Every wrapper follows one rule: a tensor on the CPU takes the plain
PyTorch version; a tensor on a CUDA device launches the kernel or raises.
Nothing falls back silently.  Each wrapper keeps a plain integer
``launches`` attribute that it increments once per kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # ptxas prints registers / spills per kernel into the build log
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every launcher in csrc/: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), ints as c_int
_SIGNATURES = {
    # (src i32 [h,w], dst f32 [4,h,w], h, w, device, stream)
    "tpufg_unpack": (_P, _P, _I, _I, _I, _P),
    # (src f32 [c,h,w], dst f32 [c,h/2,w/2], c, h, w, device, stream)
    "tpufg_box2": (_P, _P, _I, _I, _I, _I, _P),
    # (img f32 [4,ih,iw], idx_y, w_y, idx_x, w_x, out i32 [oh,ow],
    #  ih, iw, oh, ow, taps, device, stream)
    "tpufg_lanczos_packed": (_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P),
    # (prev f32 [c,h,w], curr, out f32 [2,h/16,w], c, h, w, r, smem bytes,
    #  device, stream)
    "tpufg_motion_sites": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (prev f32 [c,h,w], curr, out f32 [2,h,w], c, h, w, b, r, exact_box,
    #  smem bytes, device, stream)
    "tpufg_motion_tiled": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
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
    """Compile csrc/*.cu into one shared library unless it is current.

    Raises RuntimeError with nvcc's output if the build fails.  ptxas's
    per-kernel report is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
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
    lib.tpufg_error_string.argtypes = [ctypes.c_int]
    lib.tpufg_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, x: torch.Tensor, *args) -> None:
    """Call launcher ``name`` on ``x``'s device and current stream; raise
    if CUDA refused the launch."""
    lib = cuda_lib()
    dev = x.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(*args, dev, stream)
    if rc != 0:
        msg = lib.tpufg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain path), False for a CUDA one (kernel
    path); any other device is refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"tpufg_torch kernels run on cpu or cuda, got {x.device}")


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
