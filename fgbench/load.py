"""The load generator and the receiving end: a bank of seeded frames, the
source that offers them on the traffic's schedule, and the sink that
records when each input frame's outputs arrived.

The bank is made once in set-up from ``--seed``: one smoothed texture
(three octaves of uniform noise, bilinearly enlarged, its contrast
stretched so the codes span the whole range) and a pan of whole
pixels a frame along it, ``bank_frames`` RGBA frames with alpha 255, made on
the device in a few large calls and held contiguous in host memory.  The
source replays them in ping-pong order (0, 1, .., n-1, n-2, .., 1, 0, 1,
..), so the motion stays continuous; every seed gives the same sizes and
the same arrivals, only the picture and the pan differ.

Open loop (``fps`` > 0): frame i is due at ``t0 + i / fps``, where ``t0``
is the moment the engine first asks for a frame, and is not offered
earlier; the window holds ``seconds * fps`` frames.  Closed loop
(``fps`` 0): a frame is offered whenever the engine asks, until the
window's time is up.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F


CONTRAST = 1.8


def bank_index(i: int, n: int) -> int:
    """The bank frame of stream frame ``i`` in ping-pong order."""
    if n == 1:
        return 0
    j = i % (2 * (n - 1))
    return j if j < n else 2 * (n - 1) - j


def make_bank(seed: int, h: int, w: int, n: int, max_speed: int,
              device: torch.device) -> np.ndarray:
    """uint8 [n, h, w, 4]: ``n`` frames of one seeded texture along a pan
    of (vx, vy) whole pixels a frame, each in [-max_speed, max_speed] and
    not both 0, drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    v = torch.randint(-max_speed, max_speed + 1, (2,), generator=g,
                      device=device).tolist()
    if v == [0, 0]:
        v = [max_speed, 0]
    vx, vy = v
    th, tw = h + (n - 1) * abs(vy), w + (n - 1) * abs(vx)
    tex = torch.zeros((1, 3, th, tw), device=device)
    for cell, amp in ((32, 0.55), (8, 0.3), (2, 0.15)):
        coarse = torch.rand((1, 3, -(-th // cell) + 1, -(-tw // cell) + 1),
                            generator=g, device=device)
        tex += amp * F.interpolate(coarse, scale_factor=cell,
                                   mode="bilinear")[..., :th, :tw]
    # stretched about mid-grey so the codes span the whole range
    tex = (tex[0] - 0.5) * CONTRAST + 0.5
    tex = torch.round(tex.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full((1, h, w), 255, dtype=torch.uint8, device=device)
    x0 = (n - 1) * abs(vx) if vx < 0 else 0
    y0 = (n - 1) * abs(vy) if vy < 0 else 0
    out = np.empty((n, h, w, 4), dtype=np.uint8)
    for j in range(n):
        y, x = y0 + j * vy, x0 + j * vx
        frame = torch.cat([tex[:, y:y + h, x:x + w], alpha])
        out[j] = frame.permute(1, 2, 0).cpu().numpy()
    return out


class BankSource:
    """Frames of the bank in ping-pong order, ``count`` of them, or, with
    ``seconds``, until that long after the first is asked for; due at
    ``t0 + i / fps`` where ``fps`` > 0.  ``const_alpha``: every frame's
    alpha is 255, as in every video file a user feeds in."""

    const_alpha = True

    def __init__(self, bank: np.ndarray, fps: float = 0.0,
                 count: int | None = None, seconds: float | None = None,
                 span=contextlib.nullcontext, clock=time.perf_counter,
                 sleep=time.sleep):
        self.bank, self.fps = bank, float(fps)
        self.count, self.seconds = count, seconds
        self.span, self.clock, self.sleep = span, clock, sleep
        self.t0: float | None = None
        self.offered = 0      # frames handed to the engine
        self.late_s = 0.0     # how far behind its schedule the source ran

    def due(self, i: int) -> float:
        return self.t0 + i / self.fps

    def __iter__(self):
        n = len(self.bank)
        i = 0
        while self.count is None or i < self.count:
            now = self.clock()
            if self.t0 is None:
                self.t0 = now
            if self.seconds is not None and now - self.t0 >= self.seconds:
                return
            if self.fps > 0:
                wait = self.due(i) - now
                if wait > 0:
                    with self.span("fgbench.source_wait"):
                        self.sleep(wait)
                else:
                    self.late_s = max(self.late_s, -wait)
            self.offered = i + 1
            yield self.bank[bank_index(i, n)]
            i += 1


class RecordingSink:
    """Takes the engine's outputs in order: frame 0 has one output, every
    later frame ``k`` (its ``k - 1`` in-between frames, then itself).
    Records when each output arrived and keeps, for the check, the outputs
    of the frames ``sample`` admits (``fgbench.check.Sample``); writes
    nothing and holds no other output past its ``write``.

    The engine hands over a fresh host array for every output; the sink
    keeps the sampled ones as they are.  A copy on the engine's thread
    (33 MB, ~20 ms under the profiler) delayed the frames behind it into
    the p99, and holding every frame's arrays until the next moved config
    4's transcode rate by up to 2x, through where the host allocator put
    the program's next arrays."""

    needs_host = True

    def __init__(self, wire_format: str, k: int, sample=None,
                 span=contextlib.nullcontext, clock=time.perf_counter):
        self.wire_format = wire_format
        self.k, self.sample = k, sample
        self.span, self.clock = span, clock
        self.times: list[float] = []
        self.kept: dict[int, list] = {}

    def frame_of(self, j: int) -> int:
        """The input frame of output ``j``."""
        return 0 if j == 0 else (j - 1) // self.k + 1

    def last_output(self, i: int) -> int:
        """The index of frame ``i``'s last output (the frame itself)."""
        return i * self.k

    def write(self, frame: np.ndarray) -> None:
        with self.span("fgbench.sink"):
            j = len(self.times)
            self.times.append(self.clock())
            i = self.frame_of(j)
            if self.sample is not None and (j == 0 or (j - 1) % self.k == 0):
                keep, evicted = self.sample.admit(i)   # frame i's first output
                self.kept.pop(evicted, None)
                if keep:
                    self.kept[i] = []
            if i in self.kept:
                self.kept[i].append(frame)

    def close(self) -> None:
        pass

    def delivered(self) -> int:
        """Input frames whose every output has arrived."""
        n = len(self.times)
        return 0 if n == 0 else (n - 1) // self.k + 1

    def arrival(self, i: int) -> float:
        return self.times[self.last_output(i)]
