"""Quality validation harness: the fast path against f32 and the oracle.

Counterpart of ``tpufg/validate.py``, with the same arguments and log
lines.  For each frame pair of a source it runs the fast step in the given
dtype, the fast step in f32 and the exact (oracle) step on one CUDA card,
and reports SSIM / PSNR / max |err| of the first in-between frame:

- precision: fast (``--dtype``, bf16 by default) against fast f32, the
  same algorithm: the BASELINE gate, SSIM >= ``--threshold`` (0.999);
- fidelity: fast against the exact oracle (the full per-pixel exhaustive
  search), reported; in pyramid mode it also measures the pyramid's
  approximation, a quality trade-off and not a numeric defect.

    python -m tpufg_torch.validate synthetic:1920x1080 --frames 2 \\
        --output-width 3840 --output-height 2160

Exit codes: 0 PASS, 1 error (no CUDA device, a bad source or size), 2
FAIL.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpufg_torch.config import ConfigError, EngineConfig, resolve_sizes
from tpufg_torch.engine.pipeline import make_interp_step
from tpufg_torch.io.sources import SourceError, open_source
from tpufg_torch.kernels.common import resolve_device
from tpufg_torch.utils.logging import get_logger
from tpufg_torch.utils.quality import psnr, ssim


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpufg_torch.validate",
                                description=__doc__)
    p.add_argument("input")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--motion-mode",
                   choices=["pyramid", "exhaustive", "none"],
                   default="pyramid")
    p.add_argument("--input-width", type=int, default=0)
    p.add_argument("--input-height", type=int, default=0)
    p.add_argument("--output-width", type=int, default=0)
    p.add_argument("--output-height", type=int, default=0)
    p.add_argument("--threshold", type=float, default=0.999)
    return p


def main(argv=None) -> int:
    log = get_logger()
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(None)
    except RuntimeError as e:
        log.error(str(e))
        return 1
    try:
        source = open_source(args.input, args.input_width, args.input_height,
                             frames=args.frames + 1)
        cfg = resolve_sizes(
            EngineConfig(
                input_width=args.input_width, input_height=args.input_height,
                output_width=args.output_width,
                output_height=args.output_height,
                dtype=args.dtype, motion_mode=args.motion_mode,
            ),
            detected_input=source.size,
        )
    except (ConfigError, SourceError, OSError) as e:
        log.error(str(e))
        return 1

    f32_cfg = EngineConfig(**{**cfg.__dict__, "dtype": "f32"})
    fast = make_interp_step(cfg, device=device)
    fast32 = make_interp_step(f32_cfg, device=device)
    exact = make_interp_step(f32_cfg, "exact", device=device)

    prec_ssims, fid_ssims, psnrs, maxerrs = [], [], [], []
    prev = None
    n_pairs = 0
    for frame in source:
        cur = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
        if prev is not None:
            a, b, e = (step(prev, cur)[0].cpu().numpy().astype(np.float64)
                       / 255.0 for step in (fast, fast32, exact))
            prec_ssims.append(ssim(b, a))
            fid_ssims.append(ssim(e, a))
            psnrs.append(psnr(b, a))
            maxerrs.append(float(np.abs(a - b).max()))
            n_pairs += 1
            if n_pairs >= args.frames:
                break
        prev = cur
    source.close()

    if not prec_ssims:
        log.error("source yielded fewer than 2 frames")
        return 1
    mean_ssim = float(np.mean(prec_ssims))
    log.info(f"pairs: {n_pairs}  precision SSIM (vs f32 path) mean "
             f"{mean_ssim:.6f} min {min(prec_ssims):.6f}  PSNR "
             f"{np.mean(psnrs):.2f} dB  max|err| {max(maxerrs):.4f}")
    log.info(f"fidelity SSIM (vs exact oracle, incl. motion-algorithm "
             f"differences): mean {np.mean(fid_ssims):.6f}")
    ok = mean_ssim >= args.threshold
    log.info(f"precision SSIM >= {args.threshold}: "
             f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
