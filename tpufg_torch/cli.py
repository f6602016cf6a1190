"""Command-line interface of the port: ``python -m tpufg_torch.cli``.

Counterpart of ``tpufg/cli.py``, with the same flag surface (the parser
is tpufg's ``build_parser``).  Runs on the CUDA device and exits with an
error when there is none.  Flags outside the ported slice raise
NotImplementedError naming the flag, before any device is looked for.
``--motion-mode learned`` loads ``--model-path``, or without it the newest
head in ``checkpoints/``; a head outside the v3 family is refused the same
way.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from tpufg.cli import build_parser
from tpufg.config import ConfigError, EngineConfig, resolve_sizes
from tpufg.io.sinks import AsyncSink, open_sink
from tpufg.io.sources import SourceError, open_source
from tpufg.utils.logging import get_logger
from tpufg_torch.engine.pipeline import unported_settings
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.kernels.common import resolve_device
from tpufg_torch.models import rife


def _unported_flags(args) -> list[str]:
    """Flags whose feature lives outside the pipeline config."""
    out = []
    if args.quality:
        out.append("--quality")
    if args.devices > 1:
        out.append("--devices")
    for flag, val in (("--preview", args.preview), ("--trace", args.trace),
                      ("--debug-checks", args.debug_checks)):
        if val:
            out.append(flag)
    return out


def _config(args) -> EngineConfig:
    return EngineConfig(
        input_width=args.input_width,
        input_height=args.input_height,
        output_width=args.output_width,
        output_height=args.output_height,
        target_fps=args.target_fps if args.target_fps is not None else 60,
        enable_interpolation=not args.no_interpolation,
        interpolation_factor=args.interpolation_factor,
        lanczos_a=args.lanczos_a,
        block_size=args.block_size,
        search_radius=args.search_radius,
        dtype=args.dtype,
        motion_mode=args.motion_mode,
        overlay=args.overlay,
        fps_multiplier=args.fps_multiplier,
        mv_grid=args.mv_grid,
        subpel=args.subpel,
        mv_bias=args.mv_bias,
        mv_filter=args.mv_filter,
        occlusion_blend=args.occlusion_blend,
        mc_fallback=args.mc_fallback,
        scene_cut_threshold=args.scene_cut,
        temporal_mv=args.temporal_mv,
    )


def run(argv: Optional[list[str]] = None):
    """Parse ``argv`` and stream; returns ``(exit_code, StreamStats or
    None)``.  :func:`main` is this without the stats."""
    log = get_logger()
    parser = build_parser()
    parser.prog = "python -m tpufg_torch.cli"
    args = parser.parse_args(argv)
    # stdout carries the y4m payload when --output is '-'
    log.to_stderr = args.output == "-"
    if not args.input:
        log.error("No input specified")
        parser.print_help()
        return 1, None

    cfg = _config(args)
    try:
        cfg.validate()
    except ConfigError as e:
        log.error(str(e))
        return 1, None
    model_params = None
    if cfg.enable_interpolation and args.motion_mode == "learned":
        path = args.model_path or rife.bundled_checkpoint()
        if not path:
            log.error("--motion-mode learned requires --model-path")
            return 1, None
        if not args.model_path:
            log.info(f"--model-path not given; using bundled {path}")
        try:
            model_params = rife.load_params(path)
        except (ValueError, OSError) as e:
            log.error(str(e))
            return 1, None
    bad = (_unported_flags(args)
           + unported_settings(cfg, args.precision, model_params))
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not yet ported to tpufg_torch")
    try:
        device = resolve_device(None)
    except RuntimeError as e:
        log.error(str(e))
        return 1, None

    try:
        source = open_source(args.input, args.input_width, args.input_height,
                             args.channel_order, frames=args.frames or 300)
    except (SourceError, OSError) as e:
        log.error(str(e))
        return 1, None
    if args.target_fps is None and source.fps:
        cfg.target_fps = max(1, int(round(source.fps)))
    try:
        cfg = resolve_sizes(cfg, detected_input=source.size)
    except ConfigError as e:
        log.error(str(e))
        source.close()
        return 1, None

    log.info(f"Input: {cfg.input_width}x{cfg.input_height}  Output: "
             f"{cfg.output_width}x{cfg.output_height}  fps: {cfg.target_fps}"
             f"  interpolation: {'on' if cfg.enable_interpolation else 'off'}"
             f"  device: {torch.cuda.get_device_name(device)}")
    out_fps = cfg.target_fps * (cfg.fps_multiplier
                                if cfg.enable_interpolation else 1)
    try:
        sink = open_sink(args.output, cfg.output_width, cfg.output_height,
                         fps=float(out_fps), y4m_chroma=args.y4m_chroma)
    except (ValueError, OSError) as e:
        log.error(str(e))
        source.close()
        return 1, None
    if sink.needs_host:
        # serialize frames on a worker thread, overlapping the next step
        sink = AsyncSink(sink)

    try:
        stats = run_stream(cfg, source, sink, max_frames=args.frames,
                           paced=not args.no_pacing,
                           start_frame=args.start_frame, device=device,
                           model_params=model_params)
    except KeyboardInterrupt:
        log.info("Interrupted, cleaning up...")
        return 130, None
    except (ConfigError, ValueError) as e:
        log.error(str(e))
        return 1, None
    finally:
        source.close()
        sink.close()

    pacing = (f", deadlines {stats.paced_frames - stats.deadline_misses}"
              f"/{stats.paced_frames} met" if stats.paced_frames else "")
    log.info(f"Done: {stats.frames_in} in, {stats.frames_out} out, "
             f"fps {stats.fps:.1f}, "
             f"p99 {stats.latency.get('p99_ms', 0):.2f} ms{pacing}")
    return 0, stats


def main(argv: Optional[list[str]] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
