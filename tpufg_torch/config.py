"""Engine configuration and derivation rules.

The port's own copy of ``tpufg/config.py``: the same fields, defaults,
checks and size rules, kept here so that the port imports nothing of
``tpufg`` (``tests/test_torch_host.py`` holds the two to each other),
plus one field of the port's own, ``learned_scale`` (RIFE's IFNet, which
tpufg does not have).

Mirrors the reference's ``ScalerConfig`` (reference src/scaler.hpp:10-18) and the
config-resolution logic in ``main()`` (reference src/main.cpp:21-90):

- defaults: target_fps=60, interpolation enabled, factor=0.5
  (main.cpp:24-26);
- input size auto-detect when 0 (main.cpp:67-74 — from the X11 window there,
  from the frame source's metadata here);
- aspect-ratio completion of a missing output dimension, and
  output=input when neither is given (main.cpp:76-90).

Constants the reference hardcodes are promoted to config fields with the
reference values as defaults: LANCZOS_A=3 (shaders/scale.comp:14),
block_size=8 / search_radius=16 (src/frame_manager.cpp:329-334), and the
60-sample FPS window (src/scaler.cpp:431).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# RIFE's --scale choices (inference_video.py)
LEARNED_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)


class ConfigError(ValueError):
    """Raised for invalid or inconsistent configuration."""


@dataclasses.dataclass
class EngineConfig:
    """Full engine configuration.

    Sizes of 0 mean "derive" (see :func:`resolve_sizes`), matching the
    reference's auto-detect/aspect-completion semantics (main.cpp:67-90).
    """

    # --- reference ScalerConfig surface (scaler.hpp:10-18) ---
    input_width: int = 0
    input_height: int = 0
    output_width: int = 0
    output_height: int = 0
    target_fps: int = 60
    enable_interpolation: bool = True
    interpolation_factor: float = 0.5

    # --- kernel constants (reference hardcodes; promoted to flags) ---
    lanczos_a: int = 3            # scale.comp:14
    block_size: int = 8           # frame_manager.cpp:332
    search_radius: int = 16       # frame_manager.cpp:333 (float there, integer grid)
    fps_window: int = 60          # scaler.cpp:431

    # --- TPU-build-specific knobs (no reference equivalent) ---
    # compute dtype for the production path; the parity path is always f32
    dtype: str = "bf16"           # {"bf16", "f32"}
    # motion estimation strategy: "exhaustive" is the parity kernel
    # (motion.comp semantics); "pyramid" is the fast hierarchical search.
    motion_mode: str = "pyramid"  # {"exhaustive", "pyramid", "none", "learned"}
    # fps multiplication factor for streaming interpolation (30->60 is 2)
    fps_multiplier: int = 2
    # warp granularity in pixels: MVs are estimated on a 16-px lattice;
    # 8 bilinearly upsamples the MV field before warping; 1 is the
    # per-pixel mode — bilinearly blended block warps, the production
    # counterpart of interpolate.comp's per-pixel bilinear MV read
    mv_grid: int = 16
    # sub-pixel MV refinement: full-res ±1 px re-search + parabolic fit on
    # the block-cost surface (codec-style half/quarter-pel) — lifts the
    # integer-quantization quality ceiling on smooth motion
    subpel: bool = False
    # small-magnitude search-cost bias (codec zero/predictor preference):
    # cost += mv_bias * (|dx| + |dy|) per candidate.  On near-flat cost
    # surfaces (the aperture problem) the unbiased scan locks onto
    # arbitrary extreme candidates; a small bias snaps them to the
    # smallest displacement.  0 (default) keeps the bitwise-parity scan.
    mv_bias: float = 0.0
    # 3x3 median filter on the MV lattice (kills isolated outlier vectors)
    mv_filter: bool = False
    # occlusion-aware blending: shift toward the temporally closer frame
    # where the warped sources disagree (suppresses double-exposure ghosts)
    occlusion_blend: bool = False
    # adaptive MC->crossfade fallback: per 8x8 cell, fall back to a plain
    # crossfade wherever warping does not reduce photometric disagreement
    # vs zero motion (wrong-motion regions degrade to blur, not ghosting;
    # kernels/warp_matmul.py FB_* constants)
    mc_fallback: bool = False
    # scene-cut fallback: when the mean |prev-curr| (in [0,1] units) exceeds
    # this threshold, interpolating across the discontinuity would produce
    # a double exposure, so in-between frames repeat the temporally nearer
    # source instead.  0 disables (the shader spec blends unconditionally,
    # interpolate.comp:38)
    scene_cut_threshold: float = 0.0
    # temporal MV prediction: seed each pair's pyramid search with the
    # previous pair's MV field (classic codec temporal predictor) — the
    # tracker locks onto sustained motion far beyond the per-pair search
    # reach (models/pyramid.py TEMPORAL_CLAMP).  Streaming single-chip
    # pyramid mode only; costs warp range (wider halos).
    temporal_mv: bool = False
    # tpufg's device ring depth; the port's ingest holds no frame ahead
    # (engine/ring.py) and reads it nowhere
    ring_slots: int = 3
    # burn the reference-style stats line into output frames
    # (scaler.cpp:584-600 equivalent)
    overlay: bool = False
    # RIFE's --scale for an IFNet head (models/ifnet.py): its blocks run
    # at 4/s, 2/s and 1/s of the frame; 0.5 for UHD.  The port's own field
    # (tpufg has no IFNet); the v3 heads take only 1.0
    learned_scale: float = 1.0

    def validate(self) -> "EngineConfig":
        if not (0.0 <= self.interpolation_factor <= 1.0):
            raise ConfigError(
                f"interpolation factor must be in [0,1], got {self.interpolation_factor}"
            )
        if self.target_fps <= 0:
            raise ConfigError(f"target fps must be positive, got {self.target_fps}")
        if self.dtype not in ("bf16", "f32"):
            raise ConfigError(f"dtype must be bf16 or f32, got {self.dtype!r}")
        if self.motion_mode not in ("exhaustive", "pyramid", "none", "learned"):
            raise ConfigError(f"unknown motion mode {self.motion_mode!r}")
        if self.block_size <= 0 or self.search_radius < 0:
            raise ConfigError("block_size must be >0 and search_radius >=0")
        if self.fps_multiplier < 2:
            raise ConfigError(
                f"fps multiplier must be >= 2, got {self.fps_multiplier}")
        if self.mv_grid not in (16, 8, 1):
            raise ConfigError(
                f"mv_grid must be 16, 8 or 1 (per-pixel), got {self.mv_grid}")
        if self.mv_bias < 0.0:
            raise ConfigError(f"mv_bias must be >= 0, got {self.mv_bias}")
        if not (0.0 <= self.scene_cut_threshold < 1.0):
            raise ConfigError(
                "scene-cut threshold must be in [0,1), got "
                f"{self.scene_cut_threshold}")
        if self.temporal_mv and self.motion_mode != "pyramid":
            raise ConfigError(
                "--temporal-mv requires motion_mode='pyramid' "
                f"(got {self.motion_mode!r})")
        if self.enable_interpolation and self.motion_mode in ("pyramid",
                                                              "exhaustive"):
            # warp-envelope feasibility, checked here at flag level so a
            # bad combination fails before compile with a message naming
            # the flags (not inside kernels/warp_matmul.py): the per-frame
            # warp reach is the warp range times the largest blend weight,
            # and must stay within the warp kernel's halo ceiling
            # (eff_r <= 54 — halo = round_up(eff_r + 2, 8) <= 63 for the
            # 256-col window).
            import math
            mx = ((self.fps_multiplier - 1) / self.fps_multiplier
                  if self.fps_multiplier > 2
                  else max(self.interpolation_factor,
                           1.0 - self.interpolation_factor))
            r_warp = max(self.search_radius, 8)
            if self.temporal_mv:
                # temporal predictor widens the warp range to
                # TEMPORAL_CLAMP + pyramid reach (models/pyramid.py)
                r_warp = max(r_warp, 72)
            if math.ceil(r_warp * mx) > 54:
                limit = math.floor(54 / mx)
                raise ConfigError(
                    f"warp range {r_warp} px at blend weight {mx:.2f} "
                    "exceeds the warp kernel's 54-px reach: lower "
                    "--search-radius" +
                    (" (or drop --temporal-mv, which widens the warp "
                     "range to 72 px)" if self.temporal_mv else "") +
                    ", bring --interpolation-factor closer to 0.5, or "
                    "reduce --fps-multiplier "
                    f"(max warp range at this blend weight: {limit} px)")
        if self.learned_scale not in LEARNED_SCALES:
            raise ConfigError(
                f"learned scale must be one of {list(LEARNED_SCALES)}, got "
                f"{self.learned_scale}")
        for name in ("input_width", "input_height", "output_width", "output_height"):
            if getattr(self, name) < 0:
                raise ConfigError(f"{name} must be >= 0")
        return self


def apply_quality_preset(cfg: EngineConfig,
                         user_set: frozenset[str] = frozenset()
                         ) -> EngineConfig:
    """The measured best-quality interpolation configuration as one switch.

    Equivalent to ``--mv-grid 1 --subpel --mv-bias 0.1 --mv-filter
    --mc-fallback`` — the per-pixel OBMC warp + sub-pel MV refinement +
    aperture-stabilizing cost bias + outlier median (measured r3: 37.8 dB
    on the shear corpus vs 21.5 dB at the 16-px latency default, at ~116
    output fps 1080p->4K — ~2x the 60-fps target, which is why a preset
    can afford it) + the adaptive MC->crossfade fallback (r4: the piece
    that takes the preset past crossfade on PSNR as well as SSIM —
    37.57 dB vs crossfade's 34.33 on the rich corpus at 320x192, SSIM
    0.9779 vs 0.9355).

    ``user_set``: field names the user pinned explicitly on the command
    line — those keep their values (explicit flags beat the preset).
    Pyramid/exhaustive modes only: "none" has no MVs to refine and the
    learned head has its own flow path.
    """
    if cfg.motion_mode not in ("pyramid", "exhaustive"):
        return cfg
    upd = {}
    if "mv_grid" not in user_set:
        upd["mv_grid"] = 1
    if "subpel" not in user_set:
        upd["subpel"] = True
    if "mv_bias" not in user_set:
        upd["mv_bias"] = 0.1
    if "mv_filter" not in user_set:
        upd["mv_filter"] = True
    if "mc_fallback" not in user_set:
        upd["mc_fallback"] = True
    return dataclasses.replace(cfg, **upd)


def resolve_sizes(
    cfg: EngineConfig,
    detected_input: Optional[tuple[int, int]] = None,
) -> EngineConfig:
    """Apply the reference's size-derivation rules (main.cpp:67-90).

    ``detected_input`` is the (width, height) reported by the frame source —
    the stand-in for the reference's X11 `GetWindowSize` auto-detect
    (main.cpp:67-74, window_capture.cpp:322-330).

    Output completion exactly follows main.cpp:76-90: if only one output
    dimension is given the other is completed to preserve the input aspect
    ratio (truncating float math, as the reference casts to uint32); if
    neither is given, output = input.
    """
    cfg = dataclasses.replace(cfg)
    if cfg.input_width == 0 or cfg.input_height == 0:
        if detected_input is None:
            raise ConfigError(
                "input size not specified and source does not report one"
            )
        cfg.input_width, cfg.input_height = detected_input

    if cfg.input_width <= 0 or cfg.input_height <= 0:
        raise ConfigError(
            f"invalid input size {cfg.input_width}x{cfg.input_height}"
        )

    if cfg.output_width == 0 or cfg.output_height == 0:
        if cfg.output_height != 0:
            # width completed from height, preserving aspect (main.cpp:78-81)
            scale = float(cfg.output_height) / float(cfg.input_height)
            cfg.output_width = int(cfg.input_width * scale)
        elif cfg.output_width != 0:
            # height completed from width (main.cpp:82-85)
            scale = float(cfg.output_width) / float(cfg.input_width)
            cfg.output_height = int(cfg.input_height * scale)
        else:
            # neither given: passthrough size (main.cpp:86-89)
            cfg.output_width = cfg.input_width
            cfg.output_height = cfg.input_height

    if cfg.output_width <= 0 or cfg.output_height <= 0:
        raise ConfigError(
            f"invalid output size {cfg.output_width}x{cfg.output_height}"
        )
    return cfg.validate()
