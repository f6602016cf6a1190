"""What each timed step should hand to the sink, from the frames alone.

``make_reference(config, precision, device)`` (the device the
checkpoint's tensors go to) reads a configuration as
``fgbench/configs/*.json`` states it (its ``engine`` fields and its
``checkpoint``) and returns a :class:`Reference`:

- ``first(frame)``: the stream's first frame, scaled alone;
- ``pair(prev, curr)``: the ``k - 1`` in-between frames and curr, scaled,
  in time order (``k`` the fps multiplier);
- ``wire(out, sink_wire)``: an RGBA output as the sink takes it (the
  frame, or its y4m FRAME payload).

Frames are uint8 [H, W, 4] on the reference's device; every output is
uint8 [outH, outW, 4].  The motion modes are config 4's ``pyramid`` (the
whole-pixel blend at t = 0.5 of the pyramid's MVs, Lanczos to the output
size) and config 5's ``learned`` (the head, at identity size: the
in-between frames stored, curr passed through).  Frames whose alpha is
constant are searched on RGB alone, as the program searches them when its
source says so; the benchmark's frames are.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from fgbench.reference import frames, head, motion

F32 = torch.float32
MV_GRID = 16
PYR_MULT = 64  # the pyramid's lattice: 16 px times 2**(3 - 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    _, h, w = x.shape
    if (h, w) == (hp, wp):
        return x
    return F.pad(x, (0, wp - w, 0, hp - h), mode="replicate")


class Reference:
    def __init__(self, engine: dict, precision: str,
                 params: dict | None = None):
        self.e = engine
        self.q = frames.rounder(precision)
        self.params = params
        k = int(engine.get("fps_multiplier", 2))
        self.ts = ([float(engine.get("interpolation_factor", 0.5))] if k == 2
                   else [i / float(k) for i in range(1, k)])
        self.out_hw = (engine["output_height"], engine["output_width"])
        self.identity = self.out_hw == (engine["input_height"],
                                        engine["input_width"])
        mode = engine.get("motion_mode", "pyramid")
        if mode not in ("pyramid", "learned"):
            raise ValueError(f"the reference has no motion mode {mode!r}")
        if mode == "pyramid" and (engine.get("block_size", 8) != 8
                                  or self.ts != [0.5]):
            raise ValueError("the reference's pyramid blends pyramid MVs at "
                             "t = 0.5 with block 8")
        if mode == "learned" and params is None:
            raise ValueError("the learned mode needs the checkpoint")
        self.mode = mode

    def _scaled(self, planar: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return frames.store(planar)
        return frames.scale_store(planar, *self.out_hw,
                                  self.e.get("lanczos_a", 3))

    def first(self, frame: torch.Tensor) -> list:
        if self.identity:
            return [frames.to_u8(frame)]
        return [self._scaled(frames.unpack(frame))]

    def pair(self, prev: torch.Tensor, curr: torch.Tensor) -> list:
        with head.no_tf32():
            p, c = frames.unpack(prev), frames.unpack(curr)
            if self.mode == "learned":
                mids = self._learned(p, c)
            else:
                mids = [self._pyramid(p, c)]
            outs = [self._scaled(m) for m in mids]
            if self.identity:
                return outs + [frames.to_u8(curr)]
            return outs + [self._scaled(c)]

    def _pyramid(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        _, h, w = p.shape
        hp, wp = _round_up(h, PYR_MULT), _round_up(w, PYR_MULT)
        pp, cp = _edge_pad(p, hp, wp), _edge_pad(c, hp, wp)
        mv = motion.pyramid_mv(pp[:3], cp[:3])
        r_warp = max(int(self.e.get("search_radius", 16)), 8)
        return motion.warp_blend(pp, cp, -mv, 0.5, MV_GRID, r_warp, self.q,
                                 (h, w))

    def _learned(self, p: torch.Tensor, c: torch.Tensor) -> list:
        _, h, w = p.shape
        hp, wp = _round_up(h, 16), _round_up(w, 16)
        pp, cp = _edge_pad(p, hp, wp), _edge_pad(c, hp, wp)
        out = head.trunk(self.params, head.frame_cache(self.params, pp, self.q),
                         head.frame_cache(self.params, cp, self.q), self.q)
        return [x[:, :h, :w].contiguous()
                for x in head.tails(out, pp, cp, self.ts, self.q)]

    @staticmethod
    def wire(out: torch.Tensor, sink_wire: str) -> torch.Tensor:
        if sink_wire == "rgba":
            return out
        return frames.y4m_payload(out, sink_wire[3:])


def make_reference(config: dict, precision: str, device: torch.device,
                   root: str = ".") -> Reference:
    """The reference of ``config`` (a configuration file's contents) in
    ``precision``; a checkpoint path is read relative to ``root``."""
    params = None
    if config.get("checkpoint"):
        params = head.load_checkpoint(os.path.join(root,
                                                   config["checkpoint"]),
                                      device)
    return Reference(config["engine"], precision, params)
