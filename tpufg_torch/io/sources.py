"""Frame sources — the TPU-host replacement for the reference's WindowCapture.

The port's own copy of ``tpufg/io/sources.py``: the same sources, specs
and frames (``tests/test_torch_host.py`` holds the two to each other).

The reference ingests live X11 windows via XComposite + SHM
(src/window_capture.cpp:7-568); a TPU host has no display server, so ingest
is file/stream/synthetic (SURVEY.md §2.1 row 4).  The capture-path structure
survives: a source reports its size (GetWindowSize, window_capture.cpp:322),
auto-detection feeds config derivation (main.cpp:67-74), and each source
yields uint8 RGBA [H, W, 4] frames — the canonical channel order the
framework fixes at ingest (reference's BGRA swizzle-by-cancellation,
SURVEY.md §2.3.7, is resolved here: RawVideoSource/StdinSource accept a
``channel_order`` of "rgba" or "bgra" and normalize to RGBA).

Supported: raw packed RGBA/BGRA files, YUV4MPEG2 (C444/C420 variants,
BT.601 limited range), stdin pipes, and synthetic generators for bench.
"""

from __future__ import annotations

import io
import os
import re
import sys
from typing import Iterator, Optional

import numpy as np


class SourceError(RuntimeError):
    pass


class FrameSource:
    """Protocol: size/fps metadata + iteration of uint8 [H, W, 4] frames."""

    #: True when every frame is known to carry the SAME spatially constant
    #: alpha (y4m decode synthesizes 255; raw files are scanned at open) —
    #: lets the engine drop the zero-contribution alpha term from motion
    #: estimation (bitwise-equal MV field, ~25% less search arithmetic).
    #: None = unknown: the engine keeps the 4-channel search.
    const_alpha: Optional[bool] = None

    @property
    def size(self) -> tuple[int, int]:  # (width, height)
        raise NotImplementedError

    @property
    def fps(self) -> Optional[float]:
        return None

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: full-file alpha verification budget.  Beyond it the scan returns None
#: (unknown) instead of promising a per-stream guarantee from a prefix —
#: the engine then keeps the always-correct 4-channel motion search.
_ALPHA_SCAN_MAX_BYTES = 2 << 30


def _scan_const_alpha(path: str, width: int, height: int,
                      channel_order: str) -> Optional[bool]:
    """True when EVERY frame of a raw RGBA/BGRA file carries one
    identical constant alpha byte — a full-file scan (sequential pages,
    ~0.5 GB/s page-cached), so ``FrameSource.const_alpha``'s "every
    frame" contract is actually verified, not extrapolated from the
    opening frames (an alpha that starts constant and varies mid-stream
    would otherwise silently drop the alpha term from motion search for
    the frames where it matters).  Capture-class content has constant
    0xFF alpha, so this confirms on real streams and cheaply rejects on
    random test data; files beyond the IO budget return None
    (unknown)."""
    fb = width * height * 4
    size = os.path.getsize(path)
    n = size // fb if fb else 0
    if n <= 0:
        return False
    if size > _ALPHA_SCAN_MAX_BYTES:
        return None
    del channel_order  # RGBA and BGRA both keep alpha at pixel byte 3
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    plane = mm[3:n * fb:4]
    first = int(plane[0])
    ok = bool(plane.max() == first) and bool(plane.min() == first)
    del plane, mm
    return ok


def _to_rgba(frame: np.ndarray, order: str) -> np.ndarray:
    if order == "rgba":
        return frame
    if order == "bgra":
        return frame[..., [2, 1, 0, 3]]
    raise SourceError(f"unknown channel order {order!r}")


class RawVideoSource(FrameSource):
    """Packed 8-bit RGBA/BGRA frames, memory-mapped.

    The file is W*H*4 bytes per frame, no header — the same wire format the
    reference's SHM segment carries (window_capture.cpp:276-303).
    """

    def __init__(self, path: str, width: int, height: int,
                 channel_order: str = "rgba", fps: Optional[float] = None):
        if width <= 0 or height <= 0:
            raise SourceError("raw source needs explicit --input-width/height")
        self._w, self._h = width, height
        self._order = channel_order
        self._fps = fps
        self._frame_bytes = width * height * 4
        size = os.path.getsize(path)
        if size % self._frame_bytes:
            raise SourceError(
                f"{path}: size {size} not a multiple of frame size "
                f"{self._frame_bytes} ({width}x{height}x4)"
            )
        self._n = size // self._frame_bytes
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self.const_alpha = _scan_const_alpha(path, width, height,
                                             channel_order)

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps

    def __len__(self):
        return self._n

    def __iter__(self):
        fb = self._frame_bytes
        for i in range(self._n):
            frame = np.asarray(self._mm[i * fb:(i + 1) * fb]).reshape(
                self._h, self._w, 4)
            yield _to_rgba(frame, self._order)

    def close(self):
        del self._mm


class NativeRawSource(FrameSource):
    """Raw-file source backed by the C prefetch ring (production ingest).

    A native reader thread mmap-reads and channel-converts frames into
    page-aligned slots ahead of consumption (tpufg_torch/native/fgio.cpp), so
    disk + decode overlap device compute.  Yielded frames are views into
    ring slots, valid only until the next iteration step — consumers must
    finish the host->device copy before advancing (``zero_copy`` signals
    the engine's ingest ring to sync each upload; the upload then overlaps
    device compute, not the next host read, which is the right trade: the
    reader thread is the one we're hiding).
    """

    #: consumers must not advance the iterator while an async host->device
    #: copy of the previous frame may still be reading the slot
    zero_copy = True

    def __init__(self, path: str, width: int, height: int,
                 channel_order: str = "rgba", fps: Optional[float] = None,
                 n_slots: int = 4):
        if width <= 0 or height <= 0:
            raise SourceError("raw source needs explicit --input-width/height")
        frame_bytes = width * height * 4
        size = os.path.getsize(path)
        if size % frame_bytes:
            raise SourceError(
                f"{path}: size {size} not a multiple of frame size "
                f"{frame_bytes} ({width}x{height}x4)")
        from tpufg_torch.io.native import NativeRawRing
        self._ring = NativeRawRing(path, width, height, n_slots=n_slots,
                                   src_is_bgra=(channel_order == "bgra"))
        self.const_alpha = _scan_const_alpha(path, width, height,
                                             channel_order)
        self._w, self._h = width, height
        self._fps = fps

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps

    def __len__(self):
        return len(self._ring)

    def __iter__(self):
        return iter(self._ring)

    def close(self):
        self._ring.close()


class StdinSource(FrameSource):
    """Packed RGBA/BGRA frames streamed over a pipe (stdin by default)."""

    def __init__(self, width: int, height: int, channel_order: str = "rgba",
                 stream: Optional[io.RawIOBase] = None,
                 fps: Optional[float] = None):
        if width <= 0 or height <= 0:
            raise SourceError("stdin source needs explicit --input-width/height")
        self._w, self._h = width, height
        self._order = channel_order
        self._fps = fps
        self._stream = stream if stream is not None else sys.stdin.buffer

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps

    def __iter__(self):
        fb = self._w * self._h * 4
        while True:
            # A RawIOBase pipe may return short reads mid-stream; only a
            # zero-byte read means EOF.  Accumulate until a full frame.
            buf = bytearray()
            while len(buf) < fb:
                chunk = self._stream.read(fb - len(buf))
                if not chunk:
                    if buf:
                        from tpufg_torch.utils.logging import get_logger
                        get_logger().warning(
                            f"stdin: dropping trailing partial frame "
                            f"({len(buf)}/{fb} bytes)")
                    return
                buf += chunk
            frame = np.frombuffer(bytes(buf), np.uint8).reshape(
                self._h, self._w, 4)
            yield _to_rgba(frame, self._order)


_Y4M_RE = re.compile(rb"YUV4MPEG2 (.*?)\n", re.S)


def _bt601_to_rgb(y, u, v):
    """Limited-range BT.601 YCbCr -> full-range RGB (float32 [0,255])."""
    y = y.astype(np.float32) - 16.0
    u = u.astype(np.float32) - 128.0
    v = v.astype(np.float32) - 128.0
    r = 1.164 * y + 1.596 * v
    g = 1.164 * y - 0.392 * u - 0.813 * v
    b = 1.164 * y + 2.017 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)


class Y4MSource(FrameSource):
    """YUV4MPEG2 reader (C444 and C420* chroma, 8-bit, BT.601).

    YUV carries no alpha: every decode path (native and python) synthesizes
    a constant 255 plane, so ``const_alpha`` is True by construction.

    ``path`` may also be a binary stream (e.g. ``sys.stdin.buffer`` for
    ``ffmpeg ... -f yuv4mpeg | tpufg -``); ``header_prefix`` carries bytes
    a caller already consumed while sniffing the stream type.
    """

    const_alpha = True

    def __init__(self, path, header_prefix: bytes = b""):
        if isinstance(path, (str, bytes, os.PathLike)):
            self._f = open(path, "rb")
            self._own = True
        else:
            self._f = path
            self._own = False
            path = getattr(path, "name", None) or "<y4m stream>"
        header = bytes(header_prefix)
        while not header.endswith(b"\n"):
            ch = self._f.read(1)
            if not ch:
                raise SourceError(f"{path}: truncated y4m header")
            header += ch
        if not header.startswith(b"YUV4MPEG2"):
            raise SourceError(f"{path}: not a YUV4MPEG2 file")
        self._w = self._h = 0
        self._fps_v: Optional[float] = None
        self._chroma = "420jpeg"
        for tok in header.split()[1:]:
            k, v = tok[:1], tok[1:]
            if k == b"W":
                self._w = int(v)
            elif k == b"H":
                self._h = int(v)
            elif k == b"F":
                num, den = v.split(b":")
                self._fps_v = int(num) / int(den)
            elif k == b"C":
                self._chroma = v.decode()
        if not self._w or not self._h:
            raise SourceError(f"{path}: y4m header missing W/H")
        if self._chroma.startswith("420"):
            self._cw, self._ch_ = self._w // 2, self._h // 2
        elif self._chroma.startswith("444"):
            self._cw, self._ch_ = self._w, self._h
        else:
            raise SourceError(f"unsupported y4m chroma {self._chroma}")

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps_v

    def _read_full(self, n: int) -> bytes:
        """Accumulate exactly n bytes: raw pipes may return short reads
        mid-stream (same contract as StdinSource); only a zero-byte read
        is EOF."""
        buf = bytearray()
        while len(buf) < n:
            chunk = self._f.read(n - len(buf))
            if not chunk:
                if buf:
                    from tpufg_torch.utils.logging import get_logger
                    get_logger().warning(
                        f"y4m: dropping trailing partial frame "
                        f"({len(buf)}/{n} bytes)")
                return b""
            buf += chunk
        return bytes(buf)

    def __iter__(self):
        ysz = self._w * self._h
        csz = self._cw * self._ch_
        while True:
            line = self._f.readline()
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise SourceError("bad y4m frame marker")
            data = self._read_full(ysz + 2 * csz)
            if not data:
                return
            y = np.frombuffer(data[:ysz], np.uint8).reshape(self._h, self._w)
            u = np.frombuffer(data[ysz:ysz + csz], np.uint8).reshape(
                self._ch_, self._cw)
            v = np.frombuffer(data[ysz + csz:], np.uint8).reshape(
                self._ch_, self._cw)
            from tpufg_torch.io import native
            rgba = native.yuv_to_rgba(y, u, v)  # C path when available
            if rgba is not None:
                yield rgba
                continue
            if self._cw != self._w:  # 420 -> nearest upsample
                u = u.repeat(2, 0).repeat(2, 1)[: self._h, : self._w]
                v = v.repeat(2, 0).repeat(2, 1)[: self._h, : self._w]
            rgb = _bt601_to_rgb(y, u, v).astype(np.uint8)
            alpha = np.full((self._h, self._w, 1), 255, np.uint8)
            yield np.concatenate([rgb, alpha], axis=-1)

    def close(self):
        if self._own:
            self._f.close()


class FollowStream:
    """File-like reader that tails a GROWING file (live-ingest analog of
    the reference's continuously-updating window capture,
    src/window_capture.cpp:332-460).

    ``read`` blocks while the file is still being written: when it hits
    the current end, it polls for growth and returns data as it appears.
    Only after ``idle_timeout`` seconds without growth does it report EOF
    (a live capture has no in-band end-of-stream; idle is the analog of
    the window closing).  A writer can also end the stream explicitly by
    creating ``<path>.end``.
    """

    def __init__(self, path: str, idle_timeout: float = 5.0,
                 poll_s: float = 0.01):
        self._path = path
        self._end_path = path + ".end"
        self._timeout = float(idle_timeout)
        self._poll = float(poll_s)
        # wait for the file to appear (writer may start after us)
        import time
        deadline = time.monotonic() + self._timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise SourceError(f"{path}: did not appear within "
                                  f"{self._timeout}s (follow source)")
            time.sleep(self._poll)
        self._f = open(path, "rb")

    def read(self, n: int) -> bytes:
        import time
        buf = bytearray()
        last_progress = time.monotonic()
        while len(buf) < n:
            chunk = self._f.read(n - len(buf))
            if chunk:
                buf += chunk
                last_progress = time.monotonic()
                continue
            if os.path.exists(self._end_path):
                chunk = self._f.read(n - len(buf))
                if chunk:  # marker raced the final bytes: drain them
                    buf += chunk
                    last_progress = time.monotonic()
                    continue
                break  # explicit end marker and nothing left
            if time.monotonic() - last_progress > self._timeout:
                break
            time.sleep(self._poll)
        return bytes(buf)

    def readline(self) -> bytes:
        # header/FRAME-marker lines only (short): byte-wise is fine
        out = bytearray()
        while not out.endswith(b"\n"):
            ch = self.read(1)
            if not ch:
                break
            out += ch
        return bytes(out)

    def close(self):
        self._f.close()

    @property
    def name(self):
        return f"<follow {self._path}>"


class VideoFileSource(FrameSource):
    """Compressed video files (mp4/avi/mkv/...) decoded via OpenCV/FFmpeg.

    The real-content ingest path: the reference consumes arbitrary live
    app windows (src/window_capture.cpp:7-568); on a headless TPU host the
    equivalent arbitrary-real-content input is a video FILE, decoded on
    the host CPU while the device computes.  Decoded frames are BGR
    (OpenCV's convention) and are normalized to the canonical RGBA here —
    the same swizzle-at-ingest rule as the raw BGRA sources.  YUV-coded
    video carries no alpha, so ``const_alpha`` is True by construction
    (the engine's alpha-skip search applies).

    Soft dependency: ``cv2`` (present in this image).  When unavailable,
    raises SourceError naming the gap — every other source still works.
    """

    const_alpha = True

    def __init__(self, path: str, fps: Optional[float] = None):
        try:
            import cv2
        except ImportError:
            raise SourceError(
                f"{path}: video decode needs OpenCV (cv2); install it or "
                "transcode to .y4m (ffmpeg -i in.mp4 -pix_fmt yuv444p "
                "out.y4m)")
        if not os.path.exists(path):
            raise SourceError(f"{path}: no such file")
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise SourceError(f"{path}: OpenCV could not open "
                              "(unsupported container/codec?)")
        self._w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        if self._w <= 0 or self._h <= 0:
            raise SourceError(f"{path}: could not determine frame size")
        meta_fps = float(self._cap.get(cv2.CAP_PROP_FPS) or 0.0)
        self._fps = fps if fps else (meta_fps if meta_fps > 0 else None)
        n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        self._n = n if n > 0 else None  # container metadata; may be absent

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps

    def __len__(self):
        if self._n is None:
            raise TypeError("stream length unknown (container metadata)")
        return self._n

    def __iter__(self):
        alpha = np.full((self._h, self._w, 1), 255, np.uint8)
        while True:
            ok, frame = self._cap.read()
            if not ok:
                return
            # BGR -> RGB + synthesized alpha (one negative-stride view
            # materialized by the concat — no cv2.cvtColor extra pass)
            yield np.concatenate([frame[..., 2::-1], alpha], axis=-1)

    def close(self):
        self._cap.release()


#: container extensions routed to the OpenCV decoder by open_source
VIDEO_EXTS = (".mp4", ".m4v", ".avi", ".mkv", ".mov", ".webm", ".mpg",
              ".mpeg", ".ts")


class SyntheticSource(FrameSource):
    """Procedural moving-pattern frames for bench and demos.

    Patterns: "pan" (textured field translating at a constant pixel
    velocity — the friendliest case for block matching), "panmix" (velocity
    resampled every few frames — training data for the learned head),
    "noise", "gradient".
    """

    def __init__(self, width: int, height: int, n_frames: int = 300,
                 pattern: str = "pan", velocity: tuple[float, float] = (3.0, 1.0),
                 fps: float = 30.0, seed: int = 0):
        self._w, self._h = width, height
        self._n = n_frames
        self._pattern = pattern
        self._vel = velocity
        self._fps = fps
        self._rng = np.random.default_rng(seed)
        rng = self._rng
        pad = 256
        if pattern in ("pan", "panmix", "noise"):
            tex = rng.integers(0, 256, (height + pad, width + pad, 4),
                               dtype=np.uint8)
            if pattern in ("pan", "panmix"):
                t = tex.astype(np.float32)
                for k in (1, 2, 4):
                    t = (t + np.roll(t, k, 0) + np.roll(t, k, 1)) / 3
                tex = t.astype(np.uint8)
            self._tex = tex
        else:
            self._tex = None

    @property
    def size(self):
        return (self._w, self._h)

    @property
    def fps(self):
        return self._fps

    def __len__(self):
        return self._n

    def __iter__(self):
        vx, vy = self._vel
        ox_f = oy_f = 0.0
        for i in range(self._n):
            if self._tex is not None:
                if self._pattern == "panmix" and i % 4 == 0:
                    # new linear motion every 4 frames (keeps triplets
                    # coherent while varying velocity across the stream)
                    vx = float(self._rng.uniform(-6, 6))
                    vy = float(self._rng.uniform(-6, 6))
                ox_f = (ox_f + vx) if i else 0.0
                oy_f = (oy_f + vy) if i else 0.0
                ox = int(round(ox_f)) % 256
                oy = int(round(oy_f)) % 256
                yield np.ascontiguousarray(
                    self._tex[oy:oy + self._h, ox:ox + self._w])
            else:
                ramp = np.linspace(0, 255, self._w, dtype=np.float32)
                phase = (ramp + 3.0 * i) % 256
                frame = np.broadcast_to(
                    phase[None, :, None], (self._h, self._w, 4))
                yield frame.astype(np.uint8)


def open_source(spec: str, width: int = 0, height: int = 0,
                channel_order: str = "rgba",
                frames: int = 300) -> FrameSource:
    """Resolve an --input spec.

    - ``synthetic:WxH[:pattern]`` — procedural frames
    - ``-`` — packed RGBA on stdin (needs explicit sizes)
    - ``*.y4m`` — YUV4MPEG2
    - ``*.mp4`` / ``*.avi`` / ``*.mkv`` / ... (VIDEO_EXTS), or an explicit
      ``video:path`` — compressed video via the OpenCV/FFmpeg decoder
    - ``follow:path[:idle_timeout_s]`` — LIVE ingest: tail a growing
      y4m or raw file while a producer writes it (the reference's
      continuously-updating-capture analog); ends after idle_timeout
      (default 5 s) without growth, or at a ``path.end`` marker file
    - anything else — packed raw RGBA/BGRA file (needs explicit sizes)
    """
    if spec.startswith("video:"):
        return VideoFileSource(spec[len("video:"):])
    if spec.startswith("follow:"):
        rest = spec[len("follow:"):]
        timeout = 5.0
        if ":" in rest:
            rest, t = rest.rsplit(":", 1)
            try:
                timeout = float(t)
            except ValueError:
                raise SourceError(f"bad follow timeout {t!r} in {spec!r}")
        stream = FollowStream(rest, idle_timeout=timeout)
        if rest.endswith(".y4m"):
            return Y4MSource(stream)
        if width <= 0 or height <= 0:
            raise SourceError(
                "follow: raw stream needs explicit --input-width/height")
        return StdinSource(width, height, channel_order, stream=stream)
    if spec.startswith("synthetic:"):
        parts = spec.split(":")
        m = re.fullmatch(r"(\d+)x(\d+)", parts[1])
        if not m:
            raise SourceError(f"bad synthetic spec {spec!r} (synthetic:WxH)")
        pattern = parts[2] if len(parts) > 2 else "pan"
        return SyntheticSource(int(m.group(1)), int(m.group(2)),
                               n_frames=frames, pattern=pattern)
    if spec == "-":
        if width <= 0 or height <= 0:
            # no explicit size: sniff the stream type — a YUV4MPEG2
            # signature means a piped y4m (ffmpeg ... -f yuv4mpegpipe - |
            # tpufg -); raw stdin always requires explicit sizes
            stream = sys.stdin.buffer
            probe = stream.read(9)
            if probe == b"YUV4MPEG2":
                return Y4MSource(stream, header_prefix=probe)
            raise SourceError(
                "stdin: no --input-width/height and the stream is not "
                "YUV4MPEG2 (raw stdin input needs explicit sizes)")
        return StdinSource(width, height, channel_order)
    if spec.endswith(".y4m"):
        return Y4MSource(spec)
    if spec.lower().endswith(VIDEO_EXTS):
        return VideoFileSource(spec)
    # raw file: prefer the C prefetch ring (background read + convert into
    # page-aligned slots); fall back to the python memmap source when the
    # toolchain/library is unavailable
    from tpufg_torch.io import native
    if native.available():
        try:
            return NativeRawSource(spec, width, height, channel_order)
        except SourceError:
            raise
        except Exception:
            pass  # ring creation failed: memmap fallback below
    return RawVideoSource(spec, width, height, channel_order)
