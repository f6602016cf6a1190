"""Command-line interface of the port: ``python -m tpufg_torch.cli``.

Counterpart of ``tpufg/cli.py``, with the same flag surface plus one of
the port's own, ``--learned-scale``: its own ``build_parser`` has tpufg's
flags, defaults, choices and dests (``tests/test_torch_host.py`` holds the
two parsers to each other).  Runs on the CUDA device and exits with an
error when there is none.  Flags outside the ported slice raise
NotImplementedError naming the flag, before any device is looked for.
``--quality on|auto`` applies the quality preset
(``config.apply_quality_preset``; ``auto`` measures the preset's step rate
on the device first).  ``--motion-mode learned`` loads ``--model-path``,
or without it the newest head in ``checkpoints/``: a v3-family head, or
RIFE's IFNet (``models/ifnet.py``; ``--learned-scale`` is RIFE's
``--scale``); another head is refused the same way.  ``--preview
[HOST:]PORT`` serves the output stream over HTTP beside ``--output``
(``io/preview.py``).  ``--precision exact`` runs the GLSL-spec oracle
(``engine/pipeline.py``); ``--trace DIR`` writes a profiler trace of the
run into DIR and ``--debug-checks`` raises at the first NaN an op or
kernel makes (``utils/tracing.py``).  ``--devices`` is the one flag still
refused.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from tpufg_torch.config import (LEARNED_SCALES, ConfigError, EngineConfig,
                                apply_quality_preset, resolve_sizes)
from tpufg_torch.engine.pipeline import unported_settings
from tpufg_torch.engine.runner import measure_step_rate, run_stream
from tpufg_torch.io.preview import PreviewSink, TeeSink, parse_preview_spec
from tpufg_torch.io.sinks import AsyncSink, open_sink
from tpufg_torch.io.sources import SourceError, open_source
from tpufg_torch.kernels.common import resolve_device
from tpufg_torch.models import rife
from tpufg_torch.utils.logging import get_logger
from tpufg_torch.utils.tracing import debug_checks, trace_session


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpufg_torch.cli",
        description="Real-time upscaling and motion-compensated frame "
                    "interpolation on one CUDA GPU (the PyTorch port of "
                    "tpufg)",
        add_help=False,
    )
    p.add_argument("--help", action="help",
                   help="Show this help message")
    p.add_argument("input", nargs="?", metavar="INPUT",
                   help="input spec: raw RGBA file, *.y4m, compressed video "
                        "(*.mp4/*.avi/*.mkv/... or video:path, decoded via "
                        "OpenCV), synthetic:WxH, '-' for stdin, or "
                        "follow:path[:idle_s] to tail a growing file "
                        "(live ingest)")
    p.add_argument("--input-width", type=int, default=0, metavar="WIDTH",
                   help="Input width (default: auto-detect)")
    p.add_argument("--input-height", type=int, default=0, metavar="HEIGHT",
                   help="Input height (default: auto-detect)")
    p.add_argument("--output-width", type=int, default=0, metavar="WIDTH",
                   help="Output width")
    p.add_argument("--output-height", type=int, default=0, metavar="HEIGHT",
                   help="Output height")
    p.add_argument("--target-fps", type=int, default=None, metavar="FPS",
                   help="Target FPS (default: source metadata, else 60 — "
                        "the same auto-detect spirit as input size)")
    p.add_argument("--no-interpolation", action="store_true",
                   help="Disable frame interpolation")
    p.add_argument("--interpolation-factor", type=float, default=0.5,
                   metavar="F",
                   help="Interpolation blend factor (0.0-1.0, default: 0.5)")
    # surface beyond the reference binary
    p.add_argument("--output", default=None, metavar="SINK",
                   help="output: raw file, *.y4m, *.mp4/*.avi (OpenCV "
                        "encode), dir/ (PNGs), 'null' (default: null)")
    p.add_argument("--y4m-chroma", choices=["444", "420"], default="444",
                   help="y4m output chroma: 444 (lossless) or 420 "
                        "(half the file size)")
    p.add_argument("--frames", type=int, default=None, metavar="N",
                   help="stop after N input frames")
    p.add_argument("--start-frame", type=int, default=0, metavar="N",
                   help="skip the first N input frames (resume an offline "
                        "transcode)")
    p.add_argument("--fps-multiplier", type=int, default=2, metavar="K",
                   help="emit K-1 in-between frames per input pair "
                        "(default 2 = fps doubling; 4 = 30->120)")
    p.add_argument("--no-pacing", action="store_true",
                   help="run unpaced (benchmark mode)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="multi-chip offline transcode over N devices "
                        "(frame rows sharded with a halo exchange; "
                        "default: single-chip streaming)")
    p.add_argument("--dp", type=int, default=1, metavar="D",
                   help="with --devices: batch D consecutive frame pairs "
                        "over a data-parallel mesh axis (N/D spatial "
                        "shards each)")
    p.add_argument("--model-path", default=None, metavar="CKPT",
                   help="learned-head checkpoint for --motion-mode learned: "
                        "a v3-family .npz, or RIFE IFNet weights (a "
                        "published .pkl/.pth state dict, an .npz of its "
                        "keys, or a seeded recipe .json)")
    p.add_argument("--learned-scale", type=float, default=1.0,
                   choices=list(LEARNED_SCALES), metavar="S",
                   help="RIFE's --scale for an IFNet head: its blocks run "
                        "at 4/S, 2/S and 1/S of the frame (0.5 for UHD)")
    p.add_argument("--overlay", action="store_true",
                   help="burn the FPS/Input/Output stats line into output "
                        "frames (reference scaler overlay)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    p.add_argument("--debug-checks", action="store_true",
                   help="enable NaN/Inf guards on every computation "
                        "(debug builds' validation-layer analog)")
    p.add_argument("--motion-mode", choices=["pyramid", "exhaustive", "none", "learned"],
                   default="pyramid", help="motion estimation strategy")
    p.add_argument("--precision", choices=["fast", "exact"], default="fast",
                   help="fast = the hand-written kernels; exact = f32 "
                        "oracle (bit-exact GLSL spec)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype for the fast path")
    p.add_argument("--channel-order", choices=["rgba", "bgra"],
                   default="rgba", help="raw input channel order")
    # reference hardcoded constants, promoted (scale.comp:14,
    # frame_manager.cpp:332-333)
    p.add_argument("--lanczos-a", type=int, default=3)
    p.add_argument("--block-size", type=int, default=8)
    p.add_argument("--search-radius", type=int, default=16)
    p.add_argument("--mv-grid", type=int, choices=[16, 8, 1], default=16,
                   help="warp granularity: 16-px MV blocks, 8 (bilinearly "
                        "upsampled MV field), or 1 (per-pixel: bilinearly "
                        "blended block warps — smoothest motion "
                        "boundaries, ~2x warp cost)")
    p.add_argument("--subpel", action="store_true",
                   help="sub-pixel MV refinement: full-res ±1 px re-search "
                        "+ parabolic fit (codec-style half-pel; best "
                        "combined with --mv-grid 1)")
    p.add_argument("--mv-bias", type=float, default=0.0, metavar="B",
                   help="search-cost bias toward small displacements "
                        "(codec zero/predictor preference; ~0.1 stabilizes "
                        "the aperture problem on low-texture motion; "
                        "0 = off, bitwise-parity scan)")
    p.add_argument("--mv-filter", action="store_true",
                   help="3x3 median filter on the MV field (kills isolated "
                        "outlier vectors)")
    p.add_argument("--occlusion-blend", action="store_true",
                   help="shift the blend toward the temporally closer frame "
                        "where warped sources disagree (suppresses "
                        "double-exposure ghosts at occlusions)")
    p.add_argument("--mc-fallback", action="store_true",
                   help="adaptive fallback to a plain crossfade per 8x8 "
                        "cell wherever motion compensation does not reduce "
                        "photometric disagreement vs zero motion (wrong "
                        "motion degrades to blur instead of ghosting)")
    p.add_argument("--scene-cut", type=float, default=0.0, metavar="T",
                   help="scene-cut fallback: when mean |prev-curr| (0..1 "
                        "units) exceeds T, in-between frames repeat the "
                        "nearer source instead of interpolating across the "
                        "cut (0 disables; ~0.1 is typical)")
    p.add_argument("--quality", nargs="?", const="on",
                   choices=["on", "auto"], default=None, metavar="MODE",
                   help="best-quality interpolation preset (= --mv-grid 1 "
                        "--subpel --mv-bias 0.1 --mv-filter --mc-fallback; "
                        "explicit flags win).  "
                        "'auto' measures the preset's step rate "
                        "first and keeps it only when it sustains 1.5x the "
                        "target input rate, else falls back to the latency "
                        "defaults")
    p.add_argument("--preview", default=None, metavar="[HOST:]PORT",
                   help="serve a live preview of the output at "
                        "http://HOST:PORT/ (any browser is the display — "
                        "the reference's SDL window, src/scaler.cpp:538-609,"
                        " re-hosted for a headless GPU node).  Default "
                        "host 127.0.0.1; composes with any --output")
    p.add_argument("--temporal-mv", action="store_true",
                   help="seed each pair's motion search with the previous "
                        "pair's MV field (codec-style temporal predictor): "
                        "tracks sustained motion far beyond the per-pair "
                        "search range, at wider-warp cost.  Pyramid mode; "
                        "with --devices it needs --dp 1 (the predictor is "
                        "per-stream sequential state threaded between "
                        "pairs — row-sharded and halo-exchanged like "
                        "frames, but incompatible with dp's batched pair "
                        "parallelism)")
    return p


def _unported_flags(args) -> list[str]:
    """Flags whose feature lives outside the pipeline config."""
    return ["--devices"] if args.devices > 1 else []


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
        learned_scale=args.learned_scale,
    )


def _quality_config(args, parser, cfg: EngineConfig, device,
                    log) -> EngineConfig:
    """``--quality on|auto`` (tpufg's cli.py): the preset over ``cfg``,
    explicit ``--mv-grid`` / ``--mv-bias`` kept.  ``auto`` keeps the
    preset only when its measured step rate on ``device`` sustains 1.5x
    the target input rate.  Raises ConfigError, ValueError or
    RuntimeError."""
    user_set = frozenset(n for n in ("mv_grid", "mv_bias")
                         if getattr(args, n) != parser.get_default(n))
    qcfg = apply_quality_preset(cfg, user_set).validate()
    if args.quality != "auto":
        return qcfg
    rate = measure_step_rate(qcfg, device=device)
    need = 1.5 * cfg.target_fps
    if rate >= need:
        log.info(f"--quality auto: preset sustains {rate:.1f} pairs/s >= "
                 f"1.5x target {cfg.target_fps} — quality preset on")
        return qcfg
    log.info(f"--quality auto: preset rate {rate:.1f} pairs/s < "
             f"{need:.1f} — keeping the latency defaults")
    return cfg


def run(argv: Optional[list[str]] = None):
    """Parse ``argv`` and stream; returns ``(exit_code, StreamStats or
    None)``.  :func:`main` is this without the stats."""
    log = get_logger()
    parser = build_parser()
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
        if (args.quality and cfg.enable_interpolation
                and cfg.motion_mode in ("pyramid", "exhaustive")):
            cfg = _quality_config(args, parser, cfg, device, log)
    except (ConfigError, ValueError, RuntimeError) as e:
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
    if args.preview:
        try:
            host, port = parse_preview_spec(args.preview)
            preview = PreviewSink(port, host)
        except (ValueError, OSError) as e:
            log.error(f"--preview: {e}")
            sink.close()
            source.close()
            return 1, None
        log.info(f"live preview at {preview.url}")
        sink = TeeSink(sink, preview)
    if sink.needs_host:
        # serialize frames on a worker thread, overlapping the next step
        sink = AsyncSink(sink)

    try:
        with trace_session(args.trace), debug_checks(args.debug_checks):
            stats = run_stream(cfg, source, sink, precision=args.precision,
                               max_frames=args.frames,
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
