"""ctypes bindings to the native ingest library (tpufg_torch/native/fgio.cpp).

The port's own copy of ``tpufg/io/native.py``, with one change: the
library builds into ``tpufg_torch/_build/libfgio.so`` (g++, on first use;
the directory is not committed), not beside its source.  Every entry
point has a pure-python fallback, so the package works without a
toolchain — the native path is the production ingest (pixel conversions and
a background prefetch ring are the host-side hot loop).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG, "native", "fgio.cpp")
_SO_PATH = os.path.join(_PKG, "_build", "libfgio.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    # build under a private name, then rename: processes that build at the
    # same time never load half a file
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared", "-pthread", "-o", tmp, _SRC_PATH],
            check=True, capture_output=True, timeout=240,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO_PATH) or (
                os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fg_raw_open.restype = ctypes.c_void_p
        lib.fg_raw_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                    ctypes.c_int32]
        lib.fg_raw_frames.restype = ctypes.c_int64
        lib.fg_raw_frames.argtypes = [ctypes.c_void_p]
        lib.fg_raw_frame.restype = u8p
        lib.fg_raw_frame.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fg_raw_close.argtypes = [ctypes.c_void_p]
        lib.fg_bgra_to_rgba.argtypes = [u8p, u8p, ctypes.c_int64]
        lib.fg_yuv420_to_rgba.argtypes = [u8p, u8p, u8p, u8p,
                                          ctypes.c_int32, ctypes.c_int32]
        lib.fg_yuv444_to_rgba.argtypes = [u8p, u8p, u8p, u8p,
                                          ctypes.c_int32, ctypes.c_int32]
        lib.fg_rgba_to_yuv444.argtypes = [u8p, u8p, u8p, u8p, ctypes.c_int64]
        lib.fg_down2x2.argtypes = [u8p, u8p, ctypes.c_int32, ctypes.c_int32]
        lib.fg_ring_create.restype = ctypes.c_void_p
        lib.fg_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32]
        lib.fg_ring_acquire.restype = u8p
        lib.fg_ring_acquire.argtypes = [ctypes.c_void_p]
        lib.fg_ring_release.argtypes = [ctypes.c_void_p]
        lib.fg_ring_frames.restype = ctypes.c_int64
        lib.fg_ring_frames.argtypes = [ctypes.c_void_p]
        lib.fg_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.fg_clock_create.restype = ctypes.c_void_p
        lib.fg_clock_create.argtypes = [ctypes.c_double]
        lib.fg_clock_pace.restype = ctypes.c_double
        lib.fg_clock_pace.argtypes = [ctypes.c_void_p]
        lib.fg_clock_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bgra_to_rgba(src: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 BGRA -> RGBA (native if available)."""
    lib = get_lib()
    if lib is None:
        return src[..., [2, 1, 0, 3]].copy()
    src = np.ascontiguousarray(src)
    dst = np.empty_like(src)
    lib.fg_bgra_to_rgba(_as_u8p(src), _as_u8p(dst), src.size // 4)
    return dst


def yuv_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> Optional[np.ndarray]:
    """BT.601 limited-range planes -> RGBA uint8; None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = y.shape
    dst = np.empty((h, w, 4), np.uint8)
    y = np.ascontiguousarray(y)
    u = np.ascontiguousarray(u)
    v = np.ascontiguousarray(v)
    if u.shape == y.shape:
        lib.fg_yuv444_to_rgba(_as_u8p(y), _as_u8p(u), _as_u8p(v),
                              _as_u8p(dst), w, h)
    else:
        lib.fg_yuv420_to_rgba(_as_u8p(y), _as_u8p(u), _as_u8p(v),
                              _as_u8p(dst), w, h)
    return dst


def rgba_to_yuv444(rgba: np.ndarray) -> Optional[tuple]:
    lib = get_lib()
    if lib is None:
        return None
    h, w = rgba.shape[:2]
    rgba = np.ascontiguousarray(rgba)
    y = np.empty((h, w), np.uint8)
    u = np.empty((h, w), np.uint8)
    v = np.empty((h, w), np.uint8)
    lib.fg_rgba_to_yuv444(_as_u8p(rgba), _as_u8p(y), _as_u8p(u), _as_u8p(v),
                          h * w)
    return y, u, v


def down2x2(plane: np.ndarray) -> Optional[np.ndarray]:
    """2x2 box average of a uint8 plane ((s+2)>>2); None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = plane.shape
    plane = np.ascontiguousarray(plane)
    dst = np.empty((h // 2, w // 2), np.uint8)
    lib.fg_down2x2(_as_u8p(plane), _as_u8p(dst), w, h)
    return dst


class NativeRawRing:
    """Background-prefetched raw-file frame source (double-buffered ingest).

    Wraps the C prefetch ring: a reader thread mmap-reads and
    channel-converts frames into page-aligned slots ahead of consumption.
    """

    def __init__(self, path: str, width: int, height: int,
                 n_slots: int = 4, src_is_bgra: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._w, self._h = width, height
        self._ring = lib.fg_ring_create(path.encode(), width, height,
                                        n_slots, int(src_is_bgra))
        if not self._ring:
            raise OSError(f"fg_ring_create failed for {path}")
        self._n = lib.fg_ring_frames(self._ring)

    def __len__(self):
        return self._n

    def __iter__(self):
        fb = self._w * self._h * 4
        while True:
            ptr = self._lib.fg_ring_acquire(self._ring)
            if not ptr:
                return
            frame = np.ctypeslib.as_array(ptr, shape=(self._h, self._w, 4))
            yield frame  # valid until release; consumers copy via device_put
            self._lib.fg_ring_release(self._ring)

    def close(self):
        if self._ring:
            self._lib.fg_ring_destroy(self._ring)
            self._ring = None


class NativeClock:
    """Drift-free pacing clock (absolute-deadline clock_nanosleep)."""

    def __init__(self, fps: float):
        lib = get_lib()
        self._lib = lib
        self._c = lib.fg_clock_create(float(fps)) if lib else None
        self._fps = fps
        self._fallback_next = None

    def pace(self) -> float:
        if self._c:
            return self._lib.fg_clock_pace(self._c)
        import time
        if self._fps <= 0:
            return 0.0
        now = time.perf_counter()
        if self._fallback_next is None:
            self._fallback_next = now
        self._fallback_next += 1.0 / self._fps
        delay = self._fallback_next - now
        if delay > 0:
            time.sleep(delay)
            return 0.0
        return -delay

    def reset(self):
        """Re-anchor the absolute schedule to now (drift-free clocks never
        self-recover: a late start — e.g. jit compile on the first frames —
        would otherwise be repaid one period at a time for the whole run)."""
        if self._c:
            self._lib.fg_clock_destroy(self._c)
            self._c = self._lib.fg_clock_create(float(self._fps))
        self._fallback_next = None

    def close(self):
        if self._c:
            self._lib.fg_clock_destroy(self._c)
            self._c = None
