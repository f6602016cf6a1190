"""Live preview over HTTP — the headless host's analog of the reference's
window.

The port's own copy of ``tpufg/io/preview.py`` (numpy and the standard
library only; ``tests/test_torch_host.py`` holds the two to each other).

The reference is an interactive app: every processed frame is blitted into
an SDL window next to a stats overlay (src/scaler.cpp:404-418, 538-609).
A GPU host is headless, so the live loop becomes a tiny in-process HTTP
server: ``--preview PORT`` publishes the latest output frame and the
stream stats, and any browser on the network is the display.

Design constraints (same as the reference's present path — it sits inside
the per-frame loop):

- ``write()`` must be near-free: it stores a reference to the latest frame
  under a lock and wakes long-pollers.  All encoding happens on the HTTP
  request thread, at the viewer's own rate — an unwatched preview costs
  nothing per frame.
- PNG encode (the repo's dependency-free encoder, io/sinks.py) at zlib
  level 1: the preview trades compression for latency.  ``?down=K``
  nearest-neighbor-decimates first, and the default page picks K to fit
  the frame on screen, so a 4K stream previews at viewport cost.
- ``/frame.png?after=N`` long-polls until a frame newer than N exists —
  the browser paces itself to the stream with no busy polling and no
  missed-wakeup races (condition variable with a bounded wait).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from tpufg_torch.io.sinks import FrameSink, encode_png
from tpufg_torch.utils.stats import FpsWindow

_PAGE = """<!doctype html>
<html><head><title>tpufg live preview</title><style>
 body { margin:0; background:#111; color:#ddd;
        font:13px/1.4 system-ui, sans-serif; }
 #bar { padding:6px 10px; background:#1c1c1c; position:sticky; top:0; }
 #v { display:block; max-width:100vw; image-rendering:pixelated; }
</style></head><body>
<div id="bar">tpufg &mdash; <span id="s">waiting for frames&hellip;</span></div>
<img id="v" alt="">
<script>
const img = document.getElementById('v'), bar = document.getElementById('s');
let after = -1, down = 1, url0 = null;
async function stats() {
  try {
    const r = await fetch('/stats.json', {cache: 'no-store'});
    const j = await r.json();
    if (j.width) {
      // decimate to roughly the viewport: the server sends fewer pixels,
      // the browser never upscales a preview beyond its own window
      down = Math.max(1, Math.ceil(j.width / Math.max(640, innerWidth)));
      bar.textContent = j.width + 'x' + j.height + '  frame ' + j.frames
        + '  ' + j.fps.toFixed(1) + ' fps' + (down > 1 ? '  (1/' + down
        + ' preview)' : '');
    }
  } catch (e) {}
  setTimeout(stats, 1000);
}
async function loop() {
  for (;;) {
    try {
      const r = await fetch('/frame.png?after=' + after + '&down=' + down,
                            {cache: 'no-store'});
      if (r.status === 200) {
        after = +r.headers.get('X-Frame-Index');
        const url = URL.createObjectURL(await r.blob());
        await new Promise((ok, err) => {
          img.onload = ok; img.onerror = err; img.src = url; });
        if (url0) URL.revokeObjectURL(url0);
        url0 = url;
      } else {
        await new Promise(ok => setTimeout(ok, 250));
      }
    } catch (e) { await new Promise(ok => setTimeout(ok, 500)); }
  }
}
stats(); loop();
</script></body></html>
"""


def parse_preview_spec(spec: str) -> Tuple[str, int]:
    """``PORT`` or ``HOST:PORT`` -> (host, port).  Default host is
    loopback: a preview exposes raw frames, so reaching it from another
    machine is an explicit choice (``0.0.0.0:PORT``)."""
    m = re.fullmatch(r"(?:([^:]+):)?(\d+)", spec.strip())
    if not m:
        raise ValueError(
            f"bad --preview spec {spec!r} (expected PORT or HOST:PORT)")
    return m.group(1) or "127.0.0.1", int(m.group(2))


class PreviewSink(FrameSink):
    """Publishes the latest RGBA frame at ``http://host:port/``.

    A sink like any other (usable directly as ``--output``’s peer via
    TeeSink): ``wire_format = "rgba"`` keeps the engine on the pixel wire —
    a preview cannot show y4m payload bytes.
    """

    wire_format = "rgba"

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._lock = threading.Condition()
        self._frame: Optional[np.ndarray] = None
        self._index = -1          # monotone frame counter for long-polling
        self._fps = FpsWindow(60)
        self._closed = False

        sink = self

        class Handler(BaseHTTPRequestHandler):
            # stdout/stderr belong to the stream logs, not per-request noise
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/":
                        self._send(200, "text/html; charset=utf-8",
                                   _PAGE.encode())
                    elif u.path == "/stats.json":
                        self._send(200, "application/json",
                                   json.dumps(sink._stats()).encode())
                    elif u.path == "/frame.png":
                        q = parse_qs(u.query)
                        after = int(q.get("after", ["-1"])[0])
                        down = max(1, min(16, int(q.get("down", ["1"])[0])))
                        got = sink._wait_frame(after, timeout=10.0)
                        if got is None:
                            self._send(204, "text/plain", b"")
                            return
                        frame, index = got
                        if down > 1:
                            frame = frame[::down, ::down]
                        body = encode_png(
                            np.ascontiguousarray(frame), level=1)
                        self._send(200, "image/png", body,
                                   extra=[("X-Frame-Index", str(index))])
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # viewer went away mid-response

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpufg-preview",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/"

    # -- engine side -------------------------------------------------------
    def write(self, frame):
        # frames arriving here are the sink's to keep (a pinned block each
        # on the card, engine/runner.py HostReadback): storing the
        # reference is safe and free
        with self._lock:
            self._frame = frame
            self._index += 1
            self._fps.tick()
            self._lock.notify_all()

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    # -- request-thread side ----------------------------------------------
    def _stats(self) -> dict:
        with self._lock:
            if self._frame is None:
                return {"frames": 0, "width": 0, "height": 0, "fps": 0.0}
            h, w = self._frame.shape[:2]
            return {"frames": self._index + 1, "width": int(w),
                    "height": int(h), "fps": round(self._fps.fps, 2)}

    def _wait_frame(self, after: int,
                    timeout: float) -> Optional[Tuple[np.ndarray, int]]:
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._lock:
            if self._index <= after and not self._closed:
                self._lock.wait(deadline)
            if self._frame is None or self._index <= after:
                return None
            return self._frame, self._index


class TeeSink(FrameSink):
    """Fan one stream out to several sinks (``--output`` plus a preview).

    Forces the RGBA wire: the preview (and the overlay) needs pixels, and
    every sink accepts them; per-frame cost is one extra ``write()`` whose
    preview half is a pointer store.
    """

    wire_format = "rgba"

    def __init__(self, *sinks: FrameSink):
        self._sinks = sinks
        self.needs_host = any(
            getattr(s, "needs_host", True) for s in sinks)

    def write(self, frame):
        for s in self._sinks:
            s.write(frame)

    def close(self):
        errs = []
        for s in self._sinks:
            try:
                s.close()
            except Exception as e:  # noqa: BLE001 — close every child
                errs.append(e)
        if errs:
            raise errs[0]
