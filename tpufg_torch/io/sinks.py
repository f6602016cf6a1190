"""Frame sinks — the TPU-host replacement for the reference's SDL display.

The port's own copy of ``tpufg/io/sinks.py``: the same sinks and bytes
(``tests/test_torch_host.py`` holds the two to each other).

The reference blits each output frame into an SDL window with a stats
overlay (src/scaler.cpp:536-609); headless TPU hosts write to files/streams
instead: packed raw RGBA, YUV4MPEG2 (plays in mpv/ffplay), per-frame PNGs
(pure-python encoder, no deps), or a null sink for benchmarking.
"""

from __future__ import annotations

import os
import struct
import sys
import zlib
from typing import IO, Optional

import numpy as np


class FrameSink:
    #: sinks that serialize frames need them on the host; NullSink doesn't,
    #: letting the engine skip the device->host readback entirely
    needs_host = True
    #: what write() accepts: "rgba" (uint8 [H, W, 4] frames), or
    #: "y4m420"/"y4m444" — the sink ALSO accepts ready y4m FRAME payload
    #: bytes as 2-D uint8 arrays (kernels/yuv.py device-side egress)
    wire_format = "rgba"

    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullSink(FrameSink):
    needs_host = False

    def __init__(self):
        self.count = 0

    def write(self, frame):
        self.count += 1


class RawVideoSink(FrameSink):
    """Packed RGBA8 frames, no header."""

    def __init__(self, path: str):
        self._f: IO[bytes] = (sys.stdout.buffer if path == "-"
                              else open(path, "wb"))
        self._own = path != "-"

    def write(self, frame):
        self._f.write(np.ascontiguousarray(frame).tobytes())

    def close(self):
        if self._own:
            self._f.close()


def _rgb_to_bt601(rgb: np.ndarray):
    """Full-range RGB -> limited-range BT.601 YCbCr planes (uint8).

    Python fallback for the native converter (fg_rgba_to_yuv444,
    native/fgio.cpp): SAME 16.16 fixed-point arithmetic, so the two paths
    are byte-identical (pinned by tests/test_native.py).
    """
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = ((16829 * r + 33039 * g + 6416 * b) >> 16) + 16
    u = ((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128
    v = ((28784 * r - 24103 * g - 4681 * b) >> 16) + 128
    return (np.clip(y, 0, 255).astype(np.uint8),
            np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


def _down2x2(p: np.ndarray) -> np.ndarray:
    """2x2 box average (centered siting, "420jpeg"), (s + 2) >> 2 rounding.

    Python fallback for fg_down2x2 (byte-identical arithmetic)."""
    p16 = p.astype(np.uint16)
    s = (p16[0::2, 0::2] + p16[0::2, 1::2]
         + p16[1::2, 0::2] + p16[1::2, 1::2])
    return ((s + 2) >> 2).astype(np.uint8)


class Y4MSink(FrameSink):
    """YUV4MPEG2 writer (BT.601 limited range; C444 or C420).

    C420 (2x2 box-averaged chroma) halves the file size vs C444 and is what
    players/encoders expect by default; C444 is lossless in chroma.  C420
    needs even dimensions — odd sizes fall back to C444 (with a warning).

    The RGB->YCbCr conversion (and the 420 chroma downsample) run in the
    native library when available — the reference's present path is part of
    its per-frame loop (src/scaler.cpp:536-609), so ours must keep up with
    the device: the numpy fallback computes the identical fixed-point math
    but several times slower at 4K.

    The stream header is written lazily on the first frame, not at open:
    ``--output -`` pipes into a player, and an engine/model failure before
    the first frame must not leave the consumer a y4m header for a stream
    that never arrives.
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 60.0,
                 chroma: str = "444"):
        if chroma not in ("444", "420"):
            raise ValueError(f"y4m chroma must be 444 or 420, got {chroma!r}")
        if chroma == "420" and (width % 2 or height % 2):
            from tpufg_torch.utils.logging import get_logger
            get_logger().warning(
                f"C420 needs even dimensions, got {width}x{height}: "
                f"writing C444")
            chroma = "444"
        self._chroma = chroma
        self._f = sys.stdout.buffer if path == "-" else open(path, "wb")
        self._own = path != "-"
        num = int(round(fps * 1000))
        tag = "C444" if chroma == "444" else "C420jpeg"
        self._header = (
            f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 {tag}\n"
            .encode())

    @property
    def wire_format(self):
        return "y4m" + self._chroma

    def write(self, frame):
        if self._header is not None:
            self._f.write(self._header)
            self._header = None
        if frame.ndim == 2:
            # ready FRAME payload from the device-side egress conversion
            # (kernels/yuv.py): planes already in stream order, just write
            self._f.write(b"FRAME\n")
            self._f.write(np.ascontiguousarray(frame).data)
            return
        from tpufg_torch.io import native
        planes = None
        if frame.shape[-1] == 4:
            planes = native.rgba_to_yuv444(frame)  # None without the library
        if planes is None:
            y, u, v = _rgb_to_bt601(frame[..., :3])
        else:
            y, u, v = planes
        if self._chroma == "420":
            du, dv = native.down2x2(u), native.down2x2(v)
            u = du if du is not None else _down2x2(u)
            v = dv if dv is not None else _down2x2(v)
        self._f.write(b"FRAME\n")
        self._f.write(y.tobytes())
        self._f.write(u.tobytes())
        self._f.write(v.tobytes())

    def close(self):
        if self._own:
            self._f.close()
        elif self._header is None:
            self._f.flush()


class AsyncSink(FrameSink):
    """Run another sink's writes on a worker thread (bounded queue).

    The engine's loop thread only enqueues the host frame; serialization
    (pixel conversion + file IO — the egress leg) overlaps with the next
    step's device compute, the same software pipelining the ingest ring
    gives the source side.  Ordering is preserved (single worker draining
    one FIFO); worker errors surface on the next write()/close().
    """

    def __init__(self, inner: FrameSink, depth: int = 3):
        import queue
        import threading
        self._inner = inner
        self.needs_host = inner.needs_host
        self.wire_format = getattr(inner, "wire_format", "rgba")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._done = object()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._done:
                    return
                if self._err is None:
                    self._inner.write(item)
            except BaseException as e:  # latch; re-raised on the loop thread
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        # the sink stays PERMANENTLY failed after the first worker error:
        # clearing the latch would let a caller that catches the raised
        # error keep writing, resuming the worker mid-stream and producing
        # an output with silently missing frames instead of a consistently
        # failed sink.  Every subsequent write()/close() re-raises.
        if self._err is not None:
            raise self._err

    def write(self, frame):
        self._check()
        self._q.put(frame)

    def close(self):
        if self._t.is_alive():
            self._q.put(self._done)
            self._t.join()
        self._inner.close()
        self._check()


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """Minimal RGBA8 PNG encoder (pure python: zlib + struct).

    ``level``: zlib effort — 6 for files, 1 for latency-bound consumers
    (the live preview encodes on the viewer's request thread)."""
    h, w = rgba.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    raw = b"".join(b"\x00" + rgba[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


class PNGDirSink(FrameSink):
    def __init__(self, directory: str, prefix: str = "frame"):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._prefix = prefix
        self._i = 0

    def write(self, frame):
        path = os.path.join(self._dir, f"{self._prefix}_{self._i:06d}.png")
        with open(path, "wb") as f:
            f.write(encode_png(np.ascontiguousarray(frame)))
        self._i += 1


class VideoFileSink(FrameSink):
    """Compressed video egress via OpenCV/FFmpeg (mp4/avi containers).

    The distribution-friendly counterpart of VideoFileSource: where the
    reference presents frames live in its SDL window (src/scaler.cpp:
    536-609), a headless pipeline's shareable artifact is a compressed
    file.  Encoding runs on the host CPU (wrap in AsyncSink — the engine
    does — so it overlaps device compute).  Lossy by nature: quality
    contracts are stated on the y4m/raw sinks; this one is for delivery.

    Codec is chosen by extension: mp4v for .mp4/.m4v, MJPG for .avi
    (both verified encode+decode in this image's OpenCV build; h264
    encode is not available here).
    """

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 60.0):
        try:
            import cv2
        except ImportError:
            raise ValueError(
                f"{path}: video encode needs OpenCV (cv2); use a .y4m "
                "output instead")
        ext = os.path.splitext(path)[1].lower()
        fourcc = {".mp4": "mp4v", ".m4v": "mp4v", ".avi": "MJPG"}.get(ext)
        if fourcc is None:
            raise ValueError(f"{path}: unsupported video extension {ext} "
                             "(use .mp4 or .avi)")
        self._cv2 = cv2
        self._wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc),
                                   float(fps) if fps and fps > 0 else 30.0,
                                   (width, height))
        if not self._wr.isOpened():
            raise ValueError(f"{path}: OpenCV VideoWriter failed to open "
                             f"({fourcc}, {width}x{height})")

    def write(self, frame):
        # RGBA -> BGR (VideoWriter's convention); alpha is not encodable
        self._wr.write(np.ascontiguousarray(frame[..., 2::-1]))

    def close(self):
        self._wr.release()


#: extensions routed to the OpenCV encoder by open_sink
VIDEO_SINK_EXTS = (".mp4", ".m4v", ".avi")


def open_sink(spec: Optional[str], width: int, height: int,
              fps: float = 60.0, y4m_chroma: str = "444") -> FrameSink:
    """Resolve an --output spec: null/none, ``-`` (y4m to stdout),
    *.y4m, *.mp4/*.avi (OpenCV encoder), directory/ (PNGs), raw file."""
    if spec is None or spec in ("null", "none"):
        return NullSink()
    if spec == "-":
        # stdout is for piping (| mpv -): a self-describing y4m stream,
        # not headerless raw bytes nothing can identify
        return Y4MSink("-", width, height, fps, chroma=y4m_chroma)
    if spec.endswith(".y4m"):
        return Y4MSink(spec, width, height, fps, chroma=y4m_chroma)
    if spec.lower().endswith(VIDEO_SINK_EXTS):
        return VideoFileSink(spec, width, height, fps)
    if spec.endswith("/") or os.path.isdir(spec):
        return PNGDirSink(spec.rstrip("/"))
    return RawVideoSink(spec)
