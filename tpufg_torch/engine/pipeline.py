"""Per-frame pipeline steps.

Counterpart of ``tpufg/engine/pipeline.py``.  A step is a plain function
on tensors that already live on the step's device; PyTorch runs it
eagerly (no trace, no compile).  The fast path per frame pair:

1. ``frames_to_planar`` on prev and curr (CUDA kernel, csrc/unpack.cu);
2. edge pad to the 64-px motion lattice;
3. ``pyramid_motion_search`` — box pyramid (CUDA kernel, csrc/box2.cu),
   lattice search at r=4, integer-offset refine warp, lattice search at
   r=2; the finest refine is skipped;
4. the t = 0.5 integer-offset warp and blend, cropped back;
5. ``lanczos_scale_packed`` on the in-between frame and on curr (CUDA
   kernel, csrc/lanczos_packed.cu).

``impl="plain"`` swaps the three CUDA kernels for their plain PyTorch
versions, so a run on the card can be compared with the kernel path; it
is not a fallback and the CLI does not expose it.  On CPU tensors the
kernel wrappers take their plain versions themselves.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpufg.config import EngineConfig
from tpufg_torch.kernels.common import resolve_device, round_up
from tpufg_torch.kernels.convert import (frames_to_planar,
                                         frames_to_planar_plain,
                                         planar_to_frames, planar_to_i32)
from tpufg_torch.kernels.lanczos import (lanczos_scale_packed,
                                         lanczos_scale_packed_plain)
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul
from tpufg_torch.models.pyramid import _lattice_ok, pyramid_motion_search

F32 = torch.float32

# block lattice of the production MV grid / warp
MV_GRID = 16
PYR_LEVELS = 3
_BASE_RADIUS, _REFINE_RADIUS = 4, 2


def _dtype(cfg: EngineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bf16" else torch.float32


def _kernels(impl: str):
    """(unpack, packed scale) for ``impl`` — CUDA kernels or plain torch."""
    if impl == "kernel":
        return frames_to_planar, lanczos_scale_packed
    if impl == "plain":
        return frames_to_planar_plain, lanczos_scale_packed_plain
    raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


def unported_settings(cfg: EngineConfig, precision: str = "fast") -> list[str]:
    """The command-line settings in ``cfg`` this port does not run yet."""
    out = []
    if precision != "fast":
        out.append(f"--precision {precision}")
    if cfg.overlay:
        out.append("--overlay")
    if not cfg.enable_interpolation:
        return out  # scale-only: the interpolation settings do nothing
    if cfg.motion_mode not in ("pyramid", "none"):
        out.append(f"--motion-mode {cfg.motion_mode}")
    if cfg.mv_grid != MV_GRID:
        out.append(f"--mv-grid {cfg.mv_grid}")
    for flag, on in (("--subpel", cfg.subpel), ("--mv-filter", cfg.mv_filter),
                     ("--occlusion-blend", cfg.occlusion_blend),
                     ("--mc-fallback", cfg.mc_fallback),
                     ("--scene-cut", cfg.scene_cut_threshold > 0.0),
                     ("--temporal-mv", cfg.temporal_mv)):
        if on:
            out.append(flag)
    if cfg.fps_multiplier != 2:
        out.append(f"--fps-multiplier {cfg.fps_multiplier}")
    if cfg.interpolation_factor != 0.5:
        out.append(f"--interpolation-factor {cfg.interpolation_factor}")
    if cfg.motion_mode == "pyramid":
        # the warp clips MVs to ±max(r, 8); an odd bound makes the t=0.5
        # half-offsets fractional, which only the unported warp handles
        if max(cfg.search_radius, 8) % 2:
            out.append(f"--search-radius {cfg.search_radius} (odd warp "
                       "range: fractional offsets)")
        b = cfg.block_size
        if not (_lattice_ok(_BASE_RADIUS, b, MV_GRID)
                and _lattice_ok(_REFINE_RADIUS, b, MV_GRID)):
            out.append(f"--block-size {b} (tiled search fallback)")
    return out


def check_ported(cfg: EngineConfig, precision: str = "fast") -> None:
    """Raise NotImplementedError naming every unported setting in cfg."""
    bad = unported_settings(cfg, precision)
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not yet ported to tpufg_torch")


def _check_wires(wire: str, sink_wire: str) -> None:
    if wire not in ("u8", "i32"):
        raise ValueError(f"unknown wire {wire!r}")
    if sink_wire != "rgba":
        raise NotImplementedError(
            f"sink_wire {sink_wire!r} (on-device y4m egress): not yet "
            "ported to tpufg_torch")


def _check_on(x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"step built for {device} got a frame on "
                         f"{x.device}")


def _edge_pad_chw(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    _, h, w = x.shape
    if (h, w) == (hp, wp):
        return x
    return F.pad(x, (0, wp - w, 0, hp - h), mode="replicate")


def make_scale_step(cfg: EngineConfig, wire: str = "u8",
                    sink_wire: str = "rgba",
                    device: torch.device | str | None = None,
                    impl: str = "kernel") -> Callable:
    """frame -> scaled frame (config-1 path).

    ``wire="u8"``: uint8 [H, W, 4] in and [outH, outW, 4] out;
    ``wire="i32"``: the packed int32 [H, W] wire both ways (same bytes).
    At identity size the frame passes through unchanged: the Lanczos
    identity taps are exactly 1 and 0 and the UNORM8 round trip is exact.
    """
    _check_wires(wire, sink_wire)
    device = resolve_device(device)
    unpack, scale = _kernels(impl)
    out_h, out_w = cfg.output_height, cfg.output_width
    identity = ((out_h, out_w) == (cfg.input_height, cfg.input_width)
                and cfg.input_height > 0)

    def step(frame: torch.Tensor) -> torch.Tensor:
        _check_on(frame, device)
        if identity:
            return frame
        return scale(unpack(frame), out_h, out_w, cfg.lanczos_a,
                     raw_i32=wire == "i32")

    return step


def interp_planar(p: torch.Tensor, c: torch.Tensor, *, mode: str, factors,
                  dt: torch.dtype, block_size: int, search_radius: int,
                  mv_bias: float = 0.0, motion_skip_alpha: bool = False,
                  return_mv: bool = False, impl: str = "kernel"):
    """The interpolation core: planar f32 [C, h, w] prev/curr -> one
    [C, h, w] in-between frame per blend factor (padded internally to the
    motion lattice and cropped back).  Pyramid mode runs tpufg's latency
    mode: the finest refine is skipped, so at t = 0.5 every block moves by
    whole pixels.  ``return_mv`` also returns the MV field on the padded
    lattice ([2, Hp/16, Wp/16]; None in mode "none").

    ``motion_skip_alpha`` drops alpha from motion estimation only; valid
    when both frames carry the same constant alpha (the alpha term of every
    cost is then exactly 0, so the MV field is unchanged).
    """
    _, h, w = p.shape
    if mode == "none":
        interps = [(p.to(F32) * (1.0 - tf) + c.to(F32) * tf)
                   for tf in factors]
        return (interps, None) if return_mv else interps
    if mode != "pyramid":
        raise NotImplementedError(
            f"motion mode {mode!r}: not yet ported to tpufg_torch")
    if any(tf != 0.5 for tf in factors):
        raise NotImplementedError(
            "only the integer-offset warp (t = 0.5) is ported to "
            "tpufg_torch")
    mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
    hp, wp = round_up(h, mult), round_up(w, mult)
    pp = _edge_pad_chw(p.to(F32), hp, wp)
    cp = _edge_pad_chw(c.to(F32), hp, wp)
    skip = motion_skip_alpha and pp.shape[0] == 4
    mv = pyramid_motion_search(
        pp[:3] if skip else pp, cp[:3] if skip else cp, levels=PYR_LEVELS,
        base_radius=_BASE_RADIUS, refine_radius=_REFINE_RADIUS,
        block_size=block_size, grid=MV_GRID,
        skip_finest_refine=1, bias=mv_bias, impl=impl)
    r_warp = max(search_radius, 8)
    interps = []
    for tf in factors:
        warped = warp_blend_matmul(pp, cp, -mv, factor=tf, block=MV_GRID,
                                   search_radius=r_warp, dtype=dt,
                                   integer_offsets=True, u8_exact=True)
        interps.append(warped[:, :h, :w].contiguous())
    return (interps, mv) if return_mv else interps


def make_interp_step(cfg: EngineConfig, precision: str = "fast",
                     wire: str = "u8", sink_wire: str = "rgba",
                     motion_skip_alpha: bool = False,
                     device: torch.device | str | None = None,
                     impl: str = "kernel") -> Callable:
    """(prev, curr) -> (interp_scaled, curr_scaled): the fps-doubling step.

    Frames are uint8 [H, W, 4] (``wire="u8"``) or packed int32 [H, W]
    (``wire="i32"``) on ``device``; outputs use the same wire.  Settings
    outside the ported slice raise NotImplementedError here.
    """
    check_ported(cfg, precision)
    _check_wires(wire, sink_wire)
    device = resolve_device(device)
    unpack, scale = _kernels(impl)
    out_h, out_w = cfg.output_height, cfg.output_width
    a = cfg.lanczos_a
    i32 = wire == "i32"
    dt = _dtype(cfg)
    factors = [cfg.interpolation_factor]

    def step(prev: torch.Tensor, curr: torch.Tensor):
        _check_on(prev, device)
        _check_on(curr, device)
        p = unpack(prev)
        c = unpack(curr)
        _, h, w = p.shape
        interps = interp_planar(p, c, mode=cfg.motion_mode, factors=factors,
                                dt=dt, block_size=cfg.block_size,
                                search_radius=cfg.search_radius,
                                mv_bias=cfg.mv_bias,
                                motion_skip_alpha=motion_skip_alpha,
                                impl=impl)
        if (out_h, out_w) == (h, w):
            # identity size: quantize the in-between frame, pass curr's
            # bytes through (the UNORM8 round trip is exact)
            pack = planar_to_i32 if i32 else planar_to_frames
            return tuple(pack(x) for x in interps) + (curr,)
        return tuple(scale(x, out_h, out_w, a, raw_i32=i32)
                     for x in interps + [c])

    return step
