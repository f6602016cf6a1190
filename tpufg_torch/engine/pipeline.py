"""Per-frame pipeline steps.

Counterpart of ``tpufg/engine/pipeline.py``.  A step is a plain function
on tensors that already live on the step's device; PyTorch runs it
eagerly (no trace, no compile).  Per frame pair:

1. ``frames_to_planar`` on prev and curr (CUDA kernel, csrc/unpack.cu);
   with ``--scene-cut``, the mean |prev - curr| over RGB compared with
   the threshold on the device (plain torch, no host synchronisation);
2. edge pad to the 64-px motion lattice;
3. the MV field on the 16-px lattice, by one of two motion modes:
   - ``pyramid`` (config 4, the default): box pyramid (CUDA kernel,
     csrc/box2.cu), lattice search at r=4, integer-offset refine warp,
     lattice search at r=2, the finest refine skipped; a radius that
     leaves the 16-px cell (``--block-size 12``, 16) takes the per-pixel
     tiled search instead (CUDA kernel, csrc/motion_tiled.cu); with
     ``--temporal-mv`` the previous pair's field seeds the coarse level
     (its warps then lerp fractional offsets);
   - ``exhaustive`` (config 3): the (2r+1)^2 block match at the lattice's
     site rows at block 8 (CUDA kernel, csrc/motion_sites.cu), or at every
     pixel at other block sizes (csrc/motion_tiled.cu), subsampled to the
     lattice;
4. the quality options on the MV field, each where asked, in tpufg's
   order: ``subpel`` (+-1 px re-search and parabolic fit, its probe warps
   on the warp kernel), ``mv_filter`` (3x3 median), then the upsample to
   the ``mv_grid`` lattice (``jax.image.resize``'s linear weights; 8 px
   for ``mv_grid`` 8 and 1);
5. the warp and blend at each interpolation factor (t = i/k for
   i = 1 .. k-1 at ``--fps-multiplier`` k > 2, one MV field for all),
   cropped back: whole-pixel moves where tpufg's gate proves them
   (unseeded pyramid MVs at t = 0.5 with an even warp range, the 16-px
   lattice, no subpel), the fractional lerp otherwise (exhaustive or
   seeded MVs, t != 0.5, odd ranges, the finer lattices), the per-pixel
   (OBMC) warp at ``mv_grid`` 1 (CUDA kernel, csrc/warp_obmc.cu), and the
   occlusion blend and MC fallback where asked (CUDA kernel,
   csrc/warp_epilogue.cu, on the warped pair); across a scene cut each
   in-between frame is the nearer source instead (a select on the
   device);
6. ``lanczos_scale_packed`` on each in-between frame and on curr (CUDA
   kernel, csrc/lanczos_packed.cu); at identity size the in-between
   frames are quantized and curr passes through;
7. with a y4m sink wire, every output leaves as its y4m FRAME payload
   (CUDA kernel, csrc/yuv.cu).

``precision="exact"`` runs the GLSL-spec oracle instead (tpufg's exact
path, bit for bit its jitted ``tpufg/ops/oracle.py`` on the CPU): uint8
frames read as ``x * fl(1/255)``, the per-pixel exhaustive search with the
exact box whatever the motion mode but ``none`` (CUDA kernel,
csrc/motion_tiled.cu), its MV field negated (reference bug #12), the
shader's warp and blend at each factor (csrc/oracle_warp.cu) and the
shader's Lanczos scale with its UNORM8 store on each in-between frame and
on curr (csrc/oracle_scale.cu).  It has no scene cut, temporal seed,
stream cache or alpha skip, as tpufg's has none.

``motion_mode="learned"`` (config 5, v3-family heads) replaces steps 2-5:
the frames are edge-padded to the 16-px lattice, curr's quarter frame and
encoder features are computed once (the conv3x3_s2 kernel) and prev's
come from the stream cache the step threads between pairs (``q_feed``),
the trunk ends in the conv3x3_chain kernel, and the tail warps and fuses
(``tpufg_torch/models/rife.py``).  It runs in bf16 whatever ``--dtype``
says, as tpufg's does.  With RIFE's IFNet (``tpufg_torch/models/ifnet.py``,
chosen once when the step is built) the frames are zero-padded to
``max(32, 32 / learned_scale)``, the IFNet's three blocks give the flow,
mask and warped frames, curr's Contextnet convs are computed once (prev's
come from the ``q_feed`` cache), and the context warps, U-Net and merge
give the midpoint frame, cropped back.

Each kernel wrapper takes its plain PyTorch version for CPU tensors, and
on the card inside ``kernels.common.plain_versions()`` (to compare a run
with the kernel path; the engine and the CLI never enter it).

Under a profiler session (``utils/tracing.py``) the fast interpolating
step's stages are spans that tile the engine's ``tpufg.step``:
``tpufg.step.unpack`` (step 1's unpack), ``tpufg.step.motion`` (the cut
test and steps 2-4), ``tpufg.step.head`` (the learned head's encoder and
trunk), ``tpufg.step.warp`` (step 5, or the head's tails) and
``tpufg.step.scale`` (steps 6-7).  The IFNet's stages are
``tpufg.step.ifnet`` (the pad, the three blocks and their warps,
sigmoid(mask)), ``tpufg.step.context`` (curr's Contextnet convs) and
``tpufg.step.refine`` (the context warps, U-Net, merge, clamp and crop),
with the cut test and fallback in ``tpufg.step.warp`` where ``--scene-cut``
asks for them.  The scale step and the exact path have none.  They open
only where the step runs eagerly: a step the engine replays from a CUDA
graph (``engine/graph.py``) is one ``tpufg.step.graph`` span.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpufg_torch.config import EngineConfig
from tpufg_torch.kernels.common import resolve_device, round_up
from tpufg_torch.kernels.convert import (frames_to_planar, planar_to_frames,
                                         planar_to_i32)
from tpufg_torch.kernels.lanczos import lanczos_scale_packed
from tpufg_torch.kernels.motion import (motion_search_sites,
                                        motion_search_tiled, sites_tile_w,
                                        tiled_block_mv)
from tpufg_torch.kernels.oracle import oracle_scale, oracle_warp
from tpufg_torch.kernels.resize import resize_linear
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul
from tpufg_torch.kernels.yuv import rgba_to_y4m_payload
from tpufg_torch.models import ifnet, rife
from tpufg_torch.models.pyramid import (TEMPORAL_CLAMP, median_filter_mv,
                                        pyramid_motion_search, subpel_refine)
from tpufg_torch.ops import oracle
from tpufg_torch.utils.tracing import annotate

F32 = torch.float32

# block lattice of the production MV grid / warp
MV_GRID = 16
PYR_LEVELS = 3
_BASE_RADIUS, _REFINE_RADIUS = 4, 2
# pyramid levels upsampled without a residual search (tpufg's latency mode)
SKIP_FINEST_REFINE = 1


def _dtype(cfg: EngineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bf16" else torch.float32


def _check_precision(precision: str) -> None:
    if precision not in ("fast", "exact"):
        raise ValueError(f"precision must be 'fast' or 'exact', got "
                         f"{precision!r}")


def learned_scale(cfg) -> float:
    """``cfg.learned_scale``; 1.0 for a config without the field (tpufg's
    EngineConfig, which the steps also take)."""
    return getattr(cfg, "learned_scale", 1.0)


def unported_settings(cfg: EngineConfig, precision: str = "fast",
                      model_params=None) -> list[str]:
    """The command-line settings in ``cfg`` (and the learned head in
    ``model_params``) this port does not run yet."""
    _check_precision(precision)
    out = []
    if not cfg.enable_interpolation:
        return out  # scale-only: the interpolation settings do nothing
    if cfg.motion_mode not in ("pyramid", "exhaustive", "none", "learned"):
        out.append(f"--motion-mode {cfg.motion_mode}")
    learned = cfg.motion_mode == "learned" and model_params is not None
    if learned and rife.is_ifnet(model_params):
        # the published IFNet predicts the midpoint of a pair, in f32/bf16
        if cfg.fps_multiplier != 2:
            out.append(f"--fps-multiplier {cfg.fps_multiplier} (an IFNet "
                       "head predicts the midpoint only)")
        if cfg.interpolation_factor != 0.5:
            out.append(f"--interpolation-factor {cfg.interpolation_factor} "
                       "(an IFNet head predicts the midpoint only)")
        if precision == "exact":
            out.append("--precision exact (with an IFNet head)")
        return out
    if learned and learned_scale(cfg) != 1.0:
        out.append(f"--learned-scale {learned_scale(cfg)} (a "
                   f"{rife.head_name(model_params)} head runs at one scale)")
    # the exact path runs no head (the oracle's exhaustive search instead)
    if (learned and precision == "fast"
            and not rife.is_v3(model_params)):
        out.append(f"--model-path (a {rife.head_name(model_params)} head)")
    return out


def check_ported(cfg: EngineConfig, precision: str = "fast",
                 model_params=None) -> None:
    """Raise NotImplementedError naming every unported setting in cfg."""
    bad = unported_settings(cfg, precision, model_params)
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not yet ported to tpufg_torch")


def _check_wires(wire: str, sink_wire: str) -> None:
    if wire not in ("u8", "i32"):
        raise ValueError(f"unknown wire {wire!r}")
    if sink_wire not in ("rgba", "y4m420", "y4m444"):
        raise ValueError(f"unknown sink wire {sink_wire!r}")


def _sink_packer(sink_wire: str):
    """None for the RGBA wire, else the device-side y4m payload converter
    (csrc/yuv.cu)."""
    if sink_wire == "rgba":
        return None
    chroma = sink_wire[3:]
    return lambda x: rgba_to_y4m_payload(x, chroma)


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
                    device: torch.device | str | None = None) -> Callable:
    """frame -> scaled frame (config-1 path).

    ``wire="u8"``: uint8 [H, W, 4] in and [outH, outW, 4] out;
    ``wire="i32"``: the packed int32 [H, W] wire both ways (same bytes).
    At identity size the frame passes through unchanged: the Lanczos
    identity taps are exactly 1 and 0 and the UNORM8 round trip is exact.
    ``sink_wire="y4m420"`` or ``"y4m444"``: the output leaves as its y4m
    FRAME payload (``kernels/yuv.py``), byte for byte the host egress's.
    """
    _check_wires(wire, sink_wire)
    device = resolve_device(device)
    to_y4m = _sink_packer(sink_wire)
    out_h, out_w = cfg.output_height, cfg.output_width
    identity = ((out_h, out_w) == (cfg.input_height, cfg.input_width)
                and cfg.input_height > 0)

    def step(frame: torch.Tensor) -> torch.Tensor:
        _check_on(frame, device)
        if identity:
            out = frame
        else:
            out = lanczos_scale_packed(
                frames_to_planar(frame), out_h, out_w, cfg.lanczos_a,
                raw_i32=wire == "i32" or to_y4m is not None)
        return to_y4m(out) if to_y4m else out

    return step


def make_exact_scale_step(cfg: EngineConfig,
                          device: torch.device | str | None = None
                          ) -> Callable:
    """uint8 [H, W, 4] -> uint8 [outH, outW, 4] on the oracle (config 1
    exact, tpufg's ``make_exact_scale_step``): the UNORM8 read, then the
    shader's Lanczos scale and UNORM8 store (csrc/oracle_scale.cu).  No
    identity passthrough, as tpufg's has none."""
    device = resolve_device(device)
    out_h, out_w = cfg.output_height, cfg.output_width

    def step(frame: torch.Tensor) -> torch.Tensor:
        _check_on(frame, device)
        return oracle_scale(oracle.dequantize_unorm8(frame), out_h, out_w,
                            cfg.lanczos_a)

    return step


def exact_mv(p: torch.Tensor, c: torch.Tensor, block_size: int,
             search_radius: int) -> torch.Tensor:
    """The exact step's MV field: the oracle's per-pixel exhaustive search
    on f32 [H, W, 4] frames, negated for the warp (reference bug #12), f32
    [H, W, 2]: the tiled search with the exact box (csrc/motion_tiled.cu,
    bitwise to the oracle's) on planar copies."""
    mv = motion_search_tiled(p.permute(2, 0, 1).contiguous(),
                             c.permute(2, 0, 1).contiguous(),
                             block_size=block_size,
                             search_radius=search_radius, exact_box=True)
    return (-mv).permute(1, 2, 0).contiguous()


def _make_exact_interp_step(cfg: EngineConfig,
                            device: torch.device) -> Callable:
    """(prev, curr) uint8 [H, W, 4] -> (interp_1, ..., curr_scaled) uint8
    [outH, outW, 4] on the oracle (tpufg's exact branch of
    ``make_interp_step``)."""
    out_h, out_w, a = cfg.output_height, cfg.output_width, cfg.lanczos_a
    b, r = cfg.block_size, cfg.search_radius
    factors = interp_factors(cfg)

    def step(prev: torch.Tensor, curr: torch.Tensor):
        _check_on(prev, device)
        _check_on(curr, device)
        p = oracle.dequantize_unorm8(prev)
        c = oracle.dequantize_unorm8(curr)
        # every mode but none takes the full exhaustive search
        mv = (None if cfg.motion_mode == "none"
              else exact_mv(p, c, b, r))
        outs = [oracle_scale(oracle_warp(p, c, mv, tf), out_h, out_w, a)
                for tf in factors]
        return tuple(outs) + (oracle_scale(c, out_h, out_w, a),)

    return step


def _exhaustive_mv(mp: torch.Tensor, mc: torch.Tensor, block_size: int,
                   search_radius: int) -> torch.Tensor:
    """Exhaustive search subsampled to the MV lattice (config 3): the
    sites kernel at block 8, the per-pixel tiled kernel at other block
    sizes, with tpufg's tiling arguments (which do not change the
    result).  No ``mv_bias``, as in tpufg."""
    chunk = 3 if (2 * search_radius + 1) % 3 == 0 else 1
    if block_size != 8:
        return tiled_block_mv(mp, mc, block_size, search_radius, MV_GRID,
                              tile_h=64, tile_w=512, dx_chunk=chunk)
    mv_rows = motion_search_sites(
        mp, mc, block_size=block_size, search_radius=search_radius,
        grid=MV_GRID, tile_w=sites_tile_w(search_radius, n_ch=mp.shape[0]),
        dx_chunk=chunk)
    return mv_rows[:, :, MV_GRID // 2::MV_GRID]


def scene_cut(p: torch.Tensor, c: torch.Tensor,
              threshold: float) -> torch.Tensor:
    """tpufg's cut detector: ``mean |p - c|`` over the RGB planes in f32
    against ``threshold`` (rounded to f32).  Returns a 0-d bool tensor on
    the frames' device, for :func:`torch.where`: reading it on the host
    would wait for the device.  torch's sum runs in another order than
    XLA's, so ``d`` may differ from tpufg's in its last bits."""
    d = (p[:3].to(F32) - c[:3].to(F32)).abs().mean()
    return d > threshold


def _learned_head(p: torch.Tensor, c: torch.Tensor, params: dict, q_seed):
    """The learned branch's encoder and trunk (the ``tpufg.step.head``
    span) -> (prev and curr edge-padded to the 16-px lattice, the trunk's
    output, curr's stream cache (quarter frame, encoder features))."""
    rife.check_ported_head(params)
    _, h, w = p.shape
    hp, wp = round_up(h, 16), round_up(w, 16)
    with annotate("tpufg.step.head"):
        pp = _edge_pad_chw(p.to(F32), hp, wp)
        cp = _edge_pad_chw(c.to(F32), hp, wp)
        q_curr = rife.frame_cache(params, cp)
        q_prev = (q_seed if q_seed is not None
                  else rife.frame_cache(params, pp))
        out = rife.trunk_fast(params, q_prev, q_curr)
    return pp, cp, out, q_curr


def ifnet_planar(p: torch.Tensor, c: torch.Tensor, params: dict,
                 scale: float, q_seed=None,
                 scene_cut_threshold: float = 0.0):
    """RIFE's IFNet on planar f32 prev/curr [4, h, w] -> ([the midpoint
    frame, f32 [4, h, w]], curr's stream cache, its Contextnet convs).
    ``q_seed`` is prev's cache (None: computed here).  Where ``mean |p -
    c|`` exceeds ``scene_cut_threshold`` (> 0) the midpoint is curr
    instead, as :func:`interp_planar`'s cut fallback at t = 0.5."""
    _, h, w = p.shape
    with annotate("tpufg.step.ifnet"):
        frames = ifnet.pad_frames(p, c, scale)
        flow, mask, warped = ifnet.flows(params, frames, scale)
        sig = torch.sigmoid(mask)
    with annotate("tpufg.step.context"):
        q_curr = ifnet.context(params, frames[1:2])
        q_prev = (q_seed if q_seed is not None
                  else ifnet.context(params, frames[0:1]))
    with annotate("tpufg.step.refine"):
        out = ifnet.refine(params, frames, flow, mask, sig, warped, q_prev,
                           q_curr, (h, w))
    if scene_cut_threshold > 0.0:
        with annotate("tpufg.step.warp"):
            out = torch.where(scene_cut(p, c, scene_cut_threshold),
                              c.to(F32), out)
    return [out], q_curr


def interp_planar(p: torch.Tensor, c: torch.Tensor, *, mode: str, factors,
                  dt: torch.dtype, block_size: int, search_radius: int,
                  mv_bias: float = 0.0, mv_grid: int = MV_GRID,
                  subpel: bool = False, mv_filter: bool = False,
                  occlusion_blend: bool = False, mc_fallback: bool = False,
                  scene_cut_threshold: float = 0.0, mv_seed=None,
                  motion_skip_alpha: bool = False, return_mv: bool = False,
                  model_params=None, q_seed=None, return_q: bool = False):
    """The interpolation core: planar f32 [C, h, w] prev/curr -> one
    [C, h, w] in-between frame per blend factor (padded internally to the
    motion lattice and cropped back).  ``return_mv`` also returns the MV
    field on the padded 16-px lattice ([2, Hp/16, Wp/16], after ``subpel``
    and ``mv_filter``; None in mode "none"), zeroed across a scene cut:
    the next pair's temporal seed.

    ``mode="learned"``: the head in ``model_params`` (tensors on the
    frames' device) predicts the frames, in bf16 whatever ``dt`` says.
    ``q_seed`` is prev's stream cache (None: computed here); ``return_q``
    also returns curr's, to seed the next pair.

    Motion comes from the pyramid in tpufg's latency mode (the finest
    refine skipped) or from the exhaustive search (``mode="exhaustive"``,
    config 3).  ``mv_seed`` (pyramid mode, ``--temporal-mv``): the
    previous pair's field on the padded lattice, which seeds the pyramid;
    the warp's reach then grows to ``TEMPORAL_CLAMP + 24``.  ``subpel``
    refines the MVs to sub-pixel offsets (``mv_bias`` its small-step
    preference, as the pyramid's), ``mv_filter`` takes the 3x3 median,
    and ``mv_grid`` 8 or 1 upsamples the field to an 8-px lattice: 8
    warps its blocks, 1 warps per pixel (OBMC).  The warp moves whole
    pixels only where tpufg's gate proves every offset an integer
    (unseeded pyramid latency-mode MVs on the 16-px lattice are even, so
    at t = 0.5 each half-offset is whole unless the warp's clip bound is
    odd); everywhere else it lerps fractional offsets.
    ``occlusion_blend`` and ``mc_fallback`` are the warp's blend options.

    ``scene_cut_threshold`` > 0: where ``mean |p - c|`` over RGB exceeds
    it, each in-between frame is the nearer source instead (prev for
    t < 0.5, else curr), decided on the device (:func:`scene_cut`).

    ``motion_skip_alpha`` drops alpha from motion estimation only; valid
    when both frames carry the same constant alpha (the alpha term of every
    cost is then exactly 0, so the MV field is unchanged).  The subpel
    refine keeps all channels, as tpufg's does.

    Under a profiler session the stages are spans: ``tpufg.step.motion``
    (the cut test and everything up to the MV field on the warp's
    lattice), ``tpufg.step.head`` (the learned head's encoder and trunk)
    and ``tpufg.step.warp`` (the warps or the head's tails, and the cut
    fallback; where there is no motion stage, the cut test too).
    """
    _, h, w = p.shape
    cut = None  # the scene cut's 0-d tensor, tested in the first stage

    def cut_test():
        return (scene_cut(p, c, scene_cut_threshold)
                if scene_cut_threshold > 0.0 else None)

    def cut_fallback(x: torch.Tensor, tf: float) -> torch.Tensor:
        if cut is None:
            return x
        return torch.where(cut, (p if tf < 0.5 else c).to(F32), x)

    if mode == "learned":
        pp, cp, out, q_out = _learned_head(p, c, model_params, q_seed)
        with annotate("tpufg.step.warp"):
            cut = cut_test()
            tails = rife.tails_fast(model_params, out, pp, cp, factors)
            interps = [cut_fallback(x[:, :h, :w].contiguous(), tf)
                       for x, tf in zip(tails, factors)]
        return (interps, q_out) if return_q else interps
    if mode == "none":
        with annotate("tpufg.step.warp"):
            cut = cut_test()
            # a crossfade across a cut is the double exposure the flag
            # avoids
            interps = [cut_fallback(p.to(F32) * (1.0 - tf)
                                    + c.to(F32) * tf, tf) for tf in factors]
        return (interps, None) if return_mv else interps
    if mode not in ("pyramid", "exhaustive"):
        raise NotImplementedError(
            f"motion mode {mode!r}: not yet ported to tpufg_torch")
    with annotate("tpufg.step.motion"):
        cut = cut_test()
        mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
        hp, wp = round_up(h, mult), round_up(w, mult)
        pp = _edge_pad_chw(p.to(F32), hp, wp)
        cp = _edge_pad_chw(c.to(F32), hp, wp)
        # motion-estimation views: alpha dropped when it is degenerate; the
        # output warp always reads all of pp/cp
        skip = motion_skip_alpha and pp.shape[0] == 4
        mp, mc = (pp[:3], cp[:3]) if skip else (pp, cp)
        if mode == "pyramid":
            mv = pyramid_motion_search(
                mp, mc, levels=PYR_LEVELS, base_radius=_BASE_RADIUS,
                refine_radius=_REFINE_RADIUS, block_size=block_size,
                grid=MV_GRID, skip_finest_refine=SKIP_FINEST_REFINE,
                seed=mv_seed, bias=mv_bias)
        else:
            mv = _exhaustive_mv(mp, mc, block_size, search_radius)
        # the warp clips MVs to its reach: the pyramid's own by default,
        # the temporal clamp plus the pyramid's reach when seeded
        r_warp = max(search_radius, 8)
        if mv_seed is not None:
            r_warp = max(r_warp, TEMPORAL_CLAMP + 24)
        if subpel:
            mv = subpel_refine(pp, cp, mv, grid=MV_GRID,
                               search_radius=r_warp, bias=mv_bias, dtype=dt)
        if mv_filter:
            mv = median_filter_mv(mv)
        mv_out = mv
        if cut is not None and return_mv:
            # the predictor must not leak across the discontinuity
            mv_out = torch.where(cut, torch.zeros_like(mv), mv)
        bilin = mv_grid == 1
        if mv_grid != MV_GRID:
            # both lattices have half-cell-centred sites: jax.image.resize's
            # linear weights (its second contraction adds two rounded
            # products on the reference's CPU, the first fuses them)
            f = MV_GRID // (8 if bilin else mv_grid)
            mv = resize_linear(mv, (2, mv.shape[1] * f, mv.shape[2] * f),
                               sum_axes=(1,))
    # tpufg's integer-offset gate (pipeline.py:343-347); the port fixes
    # one of its terms, skip_finest_refine (SKIP_FINEST_REFINE >= 1)
    int_offs = (mode == "pyramid" and SKIP_FINEST_REFINE >= 1
                and mv_grid == MV_GRID and mv_seed is None and not subpel
                and all(tf == 0.5 for tf in factors)
                and r_warp % 2 == 0)
    # the kernels write the cropped window at once; one MV field for all
    # the time points
    with annotate("tpufg.step.warp"):
        interps = [cut_fallback(
            warp_blend_matmul(
                pp, cp, -mv, factor=tf, block=8 if bilin else mv_grid,
                search_radius=r_warp, dtype=dt, integer_offsets=int_offs,
                bilinear=bilin, occlusion=occlusion_blend,
                mc_fallback=mc_fallback, u8_exact=True, crop=(h, w)), tf)
            for tf in factors]
    return (interps, mv_out) if return_mv else interps


def is_temporal(cfg: EngineConfig) -> bool:
    """Whether cfg's fast interpolation step threads the temporal MV seed
    (``--temporal-mv`` on the pyramid, as tpufg's; the exact step never
    does)."""
    return bool(cfg.temporal_mv and cfg.enable_interpolation
                and cfg.motion_mode == "pyramid")


def interp_factors(cfg: EngineConfig) -> list[float]:
    """The step's time points: ``interpolation_factor`` at k = 2, else
    i/k for i = 1 .. k-1 (tpufg's)."""
    k = max(2, int(cfg.fps_multiplier))
    if k == 2:
        return [cfg.interpolation_factor]
    return [i / float(k) for i in range(1, k)]


def make_interp_step(cfg: EngineConfig, precision: str = "fast",
                     wire: str = "u8", sink_wire: str = "rgba",
                     motion_skip_alpha: bool = False,
                     device: torch.device | str | None = None,
                     model_params=None, q_feed: bool = False) -> Callable:
    """(prev, curr) -> (interp_1, ..., interp_{k-1}, curr_scaled): the
    fps-multiplying step.  With ``cfg.fps_multiplier`` k it emits k - 1
    in-between frames (t = 1/k .. (k-1)/k, one MV field for all), with
    k = 2 the one at ``cfg.interpolation_factor``, then curr.

    Frames are uint8 [H, W, 4] (``wire="u8"``) or packed int32 [H, W]
    (``wire="i32"``) on ``device``; outputs use the same wire, or leave as
    y4m FRAME payloads with ``sink_wire`` "y4m420" / "y4m444" (every
    output, curr's identity passthrough included).  Settings outside the
    ported slice raise NotImplementedError here.

    ``precision="exact"``: the oracle step (see the module's docstring),
    on the uint8 wire and the RGBA sink wire only, as tpufg's; it ignores
    ``motion_skip_alpha``, ``q_feed`` and ``--temporal-mv``.

    ``cfg.temporal_mv`` (pyramid mode): the step is (prev, curr, mv_seed)
    -> (*outputs, mv_out), where ``mv_seed`` is the previous pair's
    ``mv_out`` (zeros of :func:`mv_lattice_shape` to start) and
    ``mv_out`` a new tensor, zeroed across a scene cut; the runner
    threads it between pairs on the device.

    ``model_params``: the learned head (numpy arrays or tensors), required
    for ``motion_mode="learned"``: a v3-family head, or RIFE's IFNet
    (:func:`ifnet_planar`, at ``cfg.learned_scale``), chosen here once.
    With ``q_feed`` the learned step is (prev, curr, q_seed) -> (*outputs,
    q_out): it takes prev's stream cache and returns curr's, so the runner
    threads it between pairs and each frame is encoded once (seed the
    first pair with :func:`make_q_init`).  The outputs are those of the step without the
    cache: the same functions run on the same frame.
    """
    check_ported(cfg, precision, model_params)
    _check_wires(wire, sink_wire)
    device = resolve_device(device)
    learned = cfg.motion_mode == "learned"
    if learned and model_params is None:
        raise ValueError("motion_mode='learned' requires model_params "
                         "(--model-path)")
    if precision == "exact":
        if wire != "u8":
            raise ValueError("wire='i32' applies to the fast path only "
                             "(the exact oracle speaks uint8 frames)")
        if sink_wire != "rgba":
            raise ValueError("sink_wire y4m applies to the fast path only")
        return _make_exact_interp_step(cfg, device)
    params = rife.params_to_torch(model_params, device) if learned else None
    to_y4m = _sink_packer(sink_wire)
    out_h, out_w = cfg.output_height, cfg.output_width
    a = cfg.lanczos_a
    i32 = wire == "i32"
    dt = _dtype(cfg)
    factors = interp_factors(cfg)
    temporal = is_temporal(cfg)
    if learned and rife.is_ifnet(params):
        def core(p, c, mv_seed, q_seed):
            return ifnet_planar(p, c, params, learned_scale(cfg), q_seed,
                                cfg.scene_cut_threshold)
    else:
        def core(p, c, mv_seed, q_seed):
            return interp_planar(
                p, c, mode=cfg.motion_mode, factors=factors, dt=dt,
                block_size=cfg.block_size, search_radius=cfg.search_radius,
                mv_bias=cfg.mv_bias, mv_grid=cfg.mv_grid, subpel=cfg.subpel,
                mv_filter=cfg.mv_filter, occlusion_blend=cfg.occlusion_blend,
                mc_fallback=cfg.mc_fallback,
                scene_cut_threshold=cfg.scene_cut_threshold,
                mv_seed=mv_seed, return_mv=temporal,
                motion_skip_alpha=motion_skip_alpha, model_params=params,
                q_seed=q_seed, return_q=learned)

    def body(prev: torch.Tensor, curr: torch.Tensor, mv_seed=None,
             q_seed=None):
        with annotate("tpufg.step.unpack"):
            _check_on(prev, device)
            _check_on(curr, device)
            p = frames_to_planar(prev)
            c = frames_to_planar(curr)
        _, h, w = p.shape
        res = core(p, c, mv_seed, q_seed)
        interps, state = res if (learned or temporal) else (res, None)
        with annotate("tpufg.step.scale"):
            if (out_h, out_w) == (h, w):
                # identity size: quantize the in-between frames, pass
                # curr's bytes through (the UNORM8 round trip is exact)
                pack = planar_to_i32 if i32 or to_y4m else planar_to_frames
                outs = [pack(x) for x in interps] + [curr]
            else:
                outs = [lanczos_scale_packed(x, out_h, out_w, a,
                                             raw_i32=i32 or bool(to_y4m))
                        for x in interps + [c]]
            if to_y4m is not None:
                outs = [to_y4m(o) for o in outs]
        return tuple(outs), state

    if temporal:
        def step(prev: torch.Tensor, curr: torch.Tensor, mv_seed):
            outs, mv_out = body(prev, curr, mv_seed=mv_seed)
            return outs + (mv_out,)
    elif learned and q_feed:
        def step(prev: torch.Tensor, curr: torch.Tensor, q_seed):
            outs, q_out = body(prev, curr, q_seed=q_seed)
            return outs + (q_out,)
    else:
        def step(prev: torch.Tensor, curr: torch.Tensor):
            return body(prev, curr)[0]

    return step


def make_q_init(cfg: EngineConfig, model_params,
                device: torch.device | str | None = None) -> Callable:
    """frame -> the learned head's stream-cache seed (quarter frame, bf16
    encoder features; an IFNet's four Contextnet conv outputs), computed
    as the learned step computes it (unpack, edge pad to the 16-px
    lattice; an IFNet's zero pad), so seeding a ``q_feed`` step with it
    equals the step computing prev's cache itself."""
    device = resolve_device(device)
    rife.check_ported_head(model_params)
    params = rife.params_to_torch(model_params, device)
    if rife.is_ifnet(params):
        def q_init_ifnet(frame: torch.Tensor):
            _check_on(frame, device)
            x = frames_to_planar(frame)
            return ifnet.context(params, ifnet.pad_frames(
                x, x, learned_scale(cfg))[0:1])

        return q_init_ifnet
    hp = round_up(cfg.input_height, 16)
    wp = round_up(cfg.input_width, 16)

    def q_init(frame: torch.Tensor):
        _check_on(frame, device)
        return rife.frame_cache(
            params, _edge_pad_chw(frames_to_planar(frame), hp, wp))

    return q_init


def mv_lattice_shape(cfg: EngineConfig) -> tuple[int, int, int]:
    """Shape of the temporal MV state a temporal step threads: the padded
    frame's 16-px lattice [2, Hp/16, Wp/16] (``interp_planar`` pads to the
    pyramid's 64-px lattice before estimating)."""
    mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
    hp = round_up(cfg.input_height, mult)
    wp = round_up(cfg.input_width, mult)
    return (2, hp // MV_GRID, wp // MV_GRID)
