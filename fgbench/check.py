"""What decides ``correct``: the bytes the sink received, against the plain
reference, for a sample of the window's frames drawn from the seed.

:class:`Sample` draws the sample from the seed: frame 0 (the
scale-only step) and ``size`` more, uniform over the window's frames (in
an open loop drawn beforehand, in a closed one as a reservoir as they
arrive); the sink keeps their outputs.  Once the window has closed and the engine is freed,
:func:`compare` recomputes each sampled frame's outputs with the reference
from the same bank frames (frame i's pair is frames i - 1 and i) and
counts, over every byte the sink received for them (frames, or y4m
payloads), those more than one code from the reference's.

The numbers compared, each against its limit from the configuration file
(``limits``):
- ``missing_frames``: frames the source offered whose outputs never all
  arrived, plus sampled frames with the wrong number or shape of outputs
  (limit 0);
- ``bad_byte_share``: the share of compared bytes more than one code off.
"""

from __future__ import annotations

import numpy as np
import torch

from fgbench.load import bank_index

LIMIT_NAMES = ("missing_frames", "bad_byte_share")


class Sample:
    """The frames whose outputs the check compares, drawn from the seed:
    frame 0, and ``size`` more, either drawn at once from the ``count``
    frames of an open-loop window, or, where the count is not known
    beforehand, a reservoir of ``size`` frames kept as they arrive
    (Algorithm R: uniform over however many arrive)."""

    def __init__(self, seed: int, size: int, count: int | None = None):
        self.rng = np.random.default_rng([int(seed), 0xC0FFEE])
        self.size = size
        self.picks = None
        if count is not None:
            self.picks = set(int(i) for i in self.rng.choice(
                np.arange(1, count), size=min(size, count - 1),
                replace=False))
        self.slots: list[int] = []
        self.seen = 0

    def admit(self, i: int):
        """(keep frame i, the frame it evicts or None)."""
        if i == 0:
            return True, None
        if self.picks is not None:
            return i in self.picks, None
        self.seen += 1
        if len(self.slots) < self.size:
            self.slots.append(i)
            return True, None
        j = int(self.rng.integers(0, self.seen))
        if j >= self.size:
            return False, None
        old, self.slots[j] = self.slots[j], i
        return True, old


def compare(frames: dict, wire: str, bank: np.ndarray, reference,
            device: torch.device) -> dict:
    """The check's numbers, and what they were taken over, for ``frames``
    ({frame: the outputs received for it}, each as the sink took it on
    ``wire``)."""
    n = len(bank)

    def frame(i):
        return torch.from_numpy(bank[bank_index(i, n)]).to(device)

    missing = bad = total = max_gap = 0
    with torch.no_grad():
        for i in sorted(frames):
            want = (reference.first(frame(0)) if i == 0
                    else reference.pair(frame(i - 1), frame(i)))
            got = frames[i]
            if len(got) != len(want):
                missing += 1
                continue
            for g, w in zip(got, want):
                w = reference.wire(w, wire)
                g = torch.as_tensor(np.ascontiguousarray(g)).to(device)
                if g.shape != w.shape or g.dtype != w.dtype:
                    missing += 1
                    break
                gap = (g.to(torch.int16) - w.to(torch.int16)).abs()
                bad += int((gap > 1).sum())
                total += gap.numel()
                max_gap = max(max_gap, int(gap.max()))
    return {"missing_frames": missing,
            "bad_byte_share": bad / total if total else 1.0,
            "frames_compared": len(frames), "bytes_compared": total,
            "max_code_gap": max_gap}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the compared numbers."""
    rows = {k: {"value": numbers[k], "limit": limits[k]}
            for k in LIMIT_NAMES}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
