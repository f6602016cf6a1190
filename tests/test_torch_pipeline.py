"""tpufg_torch's steps and engine against tpufg's (CPU).

Same synthetic frames through both packages.  Tolerances:
- MV fields: bitwise;
- output bytes: within 1 code, with at most 1e-3 of the bytes differing
  for dtype f32 and 1e-2 for bf16 (tpufg's bf16 Lanczos uses a split-bf16
  dot on centred operands, the port computes in f32), and SSIM >= 0.999;
- identity size (no resample): bitwise (see test_identity_size_bitwise);
- run_stream: the same frame count and within 1 code per frame;
- config 3 (exhaustive search) and the pyramid's fractional warps at
  identity size: MV fields bitwise, in-between bytes within 1 code of
  tpufg's jitted step body (its compiled CPU blend contracts into FMAs,
  which moves .5 quantization ties; measured here: at most 0.71% of the
  bytes), curr bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.config import EngineConfig
from tpufg.engine import pipeline as jpipe
from tpufg.engine.runner import run_stream as jrun_stream
from tpufg.io.sinks import FrameSink
from tpufg.io.sources import SyntheticSource
from tpufg.kernels import convert as jconv
from tpufg.kernels.convert import frames_to_planar as jplanar
from tpufg.kernels.warp_matmul import warp_blend_matmul as jwarp
from tpufg.utils.quality import ssim
from tpufg_torch.engine import pipeline as tpipe
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.kernels.convert import frames_to_planar, planar_to_i32
from tests.test_torch_warp import _oob_mask

CPU = torch.device("cpu")
CASES = [((128, 256), (256, 512)), ((72, 88), (144, 176))]


def _wire(h, w, n=3, **kw):
    """n synthetic pan frames as packed int32 [h, w] arrays."""
    return [f.view(np.int32).reshape(h, w)
            for f in SyntheticSource(w, h, n_frames=n, **kw)]


def _cfg(in_hw, out_hw, **kw):
    return EngineConfig(input_width=in_hw[1], input_height=in_hw[0],
                        output_width=out_hw[1], output_height=out_hw[0],
                        **kw)


def _bytes(x):
    return np.asarray(x).view(np.uint8)


def _assert_close_bytes(out, ref, max_frac):
    a, b = _bytes(out), _bytes(ref)
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= max_frac
    h, w = np.asarray(out).shape[:2]
    assert ssim(a.reshape(h, w, 4) / 255.0, b.reshape(h, w, 4) / 255.0) >= 0.999


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_mv_field_bitwise(in_hw, out_hw):
    fr = _wire(*in_hw, n=2)
    _, jmv = jpipe.interp_planar(*(jplanar(jnp.asarray(f)) for f in fr),
                                 mode="pyramid", factors=[0.5],
                                 dt=jnp.bfloat16, block_size=8,
                                 search_radius=16, return_mv=True)
    _, tmv = tpipe.interp_planar(*(frames_to_planar(torch.from_numpy(f))
                                   for f in fr),
                                 mode="pyramid", factors=[0.5],
                                 dt=torch.bfloat16, block_size=8,
                                 search_radius=16, return_mv=True)
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
    assert np.abs(tmv.numpy()).max() > 0  # the pan moved something


def test_motion_skip_alpha_mv_bitwise():
    # constant alpha (every real video wire): dropping it from the search
    # leaves the MV field unchanged, in both packages
    fr = [f.copy() for f in SyntheticSource(128, 64, n_frames=2)]
    for f in fr:
        f[..., 3] = 255
    jp = [jplanar(jnp.asarray(f)) for f in fr]
    tp = [frames_to_planar(torch.from_numpy(f)) for f in fr]
    kw = dict(mode="pyramid", factors=[0.5], block_size=8, search_radius=16,
              return_mv=True)
    _, ref = jpipe.interp_planar(*jp, dt=jnp.bfloat16,
                                 motion_skip_alpha=True, **kw)
    _, skip = tpipe.interp_planar(*tp, dt=torch.bfloat16,
                                  motion_skip_alpha=True, **kw)
    _, full = tpipe.interp_planar(*tp, dt=torch.bfloat16, **kw)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(skip.numpy(), full.numpy())


@pytest.mark.parametrize("in_hw,out_hw", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_steps_match_tpufg(in_hw, out_hw, dtype):
    cfg = _cfg(in_hw, out_hw, dtype=dtype)
    fr = _wire(*in_hw)
    max_frac = 1e-3 if dtype == "f32" else 1e-2
    jstep = jpipe.make_interp_step(cfg, wire="i32")
    tstep = tpipe.make_interp_step(cfg, wire="i32", device=CPU)
    for i in range(2):
        ref = jstep(jnp.asarray(fr[i]), jnp.asarray(fr[i + 1]))
        out = tstep(torch.from_numpy(fr[i]), torch.from_numpy(fr[i + 1]))
        assert len(out) == len(ref) == 2
        for o, r in zip(out, ref):
            assert o.dtype == torch.int32 and tuple(o.shape) == out_hw
            _assert_close_bytes(o.numpy(), r, max_frac)
    ref = jpipe.make_scale_step(cfg, wire="i32")(jnp.asarray(fr[0]))
    out = tpipe.make_scale_step(cfg, wire="i32", device=CPU)(
        torch.from_numpy(fr[0]))
    _assert_close_bytes(out.numpy(), ref, max_frac)


@pytest.mark.parametrize("wire", ["u8", "i32"])
def test_identity_size_bitwise(wire):
    """At identity size nothing is resampled.  curr passes through
    bitwise; the in-between frame is bitwise the UNORM8 store of tpufg's
    blend formula (one rounding per operation) over tpufg's own MV field
    and single-mode warps.  tpufg's compiled CPU step contracts the blend's
    final add into an FMA, which moves .5 quantization ties: within 1 code
    of it."""
    h, w = 64, 128
    cfg = _cfg((h, w), (h, w))
    fr = _wire(h, w)
    if wire == "u8":
        fr = [f.view(np.uint8).reshape(h, w, 4) for f in fr]
    ref = jpipe.make_interp_step(cfg, wire=wire)(jnp.asarray(fr[0]),
                                                  jnp.asarray(fr[1]))
    out = tpipe.make_interp_step(cfg, wire=wire, device=CPU)(
        torch.from_numpy(fr[0]), torch.from_numpy(fr[1]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[1].numpy(), fr[1])

    p, c = (jplanar(jnp.asarray(f)) for f in fr[:2])
    _, mv = jpipe.interp_planar(p, c, mode="pyramid", factors=[0.5],
                                dt=jnp.bfloat16, block_size=8,
                                search_radius=16, return_mv=True)
    md = np.clip(-np.asarray(mv), -16, 16)
    half = np.float32(0.5)
    blend = np.zeros((4, h, w), np.float32)
    for x, scale in ((p, -half), (c, half)):
        off = (md * scale).astype(np.float32)
        warped = np.asarray(jwarp(x, x, jnp.asarray(off), single=True,
                                  block=16, search_radius=8,
                                  dtype=jnp.bfloat16, integer_offsets=True,
                                  u8_exact=True))
        blend = blend + warped * _oob_mask(md, scale, h, w) * half
    expect = np.asarray(jconv.planar_to_frames(jnp.asarray(blend)))
    np.testing.assert_array_equal(_bytes(out[0].numpy()).reshape(h, w, 4),
                                  expect)
    d = np.abs(_bytes(out[0].numpy()).astype(np.int16)
               - _bytes(ref[0]).astype(np.int16))
    assert d.max() <= 1

    scaled = tpipe.make_scale_step(cfg, wire=wire, device=CPU)(
        torch.from_numpy(fr[2]))
    np.testing.assert_array_equal(
        scaled.numpy(),
        np.asarray(jpipe.make_scale_step(cfg, wire=wire)(jnp.asarray(fr[2]))))


def test_crossfade_mode_matches_tpufg():
    cfg = _cfg((72, 88), (144, 176), motion_mode="none", dtype="f32")
    fr = _wire(72, 88, n=2)
    ref = jpipe.make_interp_step(cfg, wire="i32")(*map(jnp.asarray, fr))
    out = tpipe.make_interp_step(cfg, wire="i32", device=CPU)(
        *map(torch.from_numpy, fr))
    for o, r in zip(out, ref):
        _assert_close_bytes(o.numpy(), r, 1e-3)


class _ListSink(FrameSink):
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))


def test_run_stream_matches_tpufg():
    cfg = _cfg((64, 96), (128, 192))
    ref, out = _ListSink(), _ListSink()
    jstats = jrun_stream(cfg, SyntheticSource(96, 64, n_frames=6), ref,
                         paced=False)
    stats = run_stream(cfg, SyntheticSource(96, 64, n_frames=6), out,
                       paced=False, device=CPU)
    assert stats.frames_in == jstats.frames_in == 6
    assert stats.frames_out == jstats.frames_out == len(out.frames) == 11
    for o, r in zip(out.frames, ref.frames):
        assert o.shape == r.shape == (128, 192, 4) and o.dtype == np.uint8
        assert np.abs(o.astype(np.int16) - r.astype(np.int16)).max() <= 1


def _mv_and_bytes_match(cfg, h, w, step=True):
    """One search per package: the MV field bitwise and the identity-size
    in-between bytes within 1 code of tpufg's step body (jitted, as
    make_interp_step compiles it).  With ``step``, the port's step too:
    the same in-between bytes, and curr passed through."""
    fr = _wire(h, w, n=2)
    kw = dict(mode=cfg.motion_mode, factors=[cfg.interpolation_factor],
              block_size=cfg.block_size, search_radius=cfg.search_radius,
              return_mv=True)

    @jax.jit
    def jbody(prev, curr):
        (mid,), mv = jpipe.interp_planar(jplanar(prev), jplanar(curr),
                                         dt=jnp.bfloat16, **kw)
        return jconv.planar_to_i32(mid), mv

    ref, jmv = jbody(*map(jnp.asarray, fr))
    (mid,), tmv = tpipe.interp_planar(*(frames_to_planar(torch.from_numpy(f))
                                        for f in fr), dt=torch.bfloat16, **kw)
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
    assert np.abs(tmv.numpy()).max() > 0  # the pan moved something
    out = planar_to_i32(mid)
    d = np.abs(_bytes(out.numpy()).astype(np.int16)
               - _bytes(ref).astype(np.int16))
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.03
    if step:
        got = tpipe.make_interp_step(cfg, wire="i32", device=CPU)(
            *map(torch.from_numpy, fr))
        np.testing.assert_array_equal(got[0].numpy(), out.numpy())
        np.testing.assert_array_equal(got[1].numpy(), fr[1])
    return tmv


@pytest.mark.parametrize("hw,b,r", [((64, 128), 8, 4), ((64, 128), 16, 4),
                                    ((128, 128), 8, 16)])
def test_exhaustive_step_matches_tpufg(hw, b, r):
    """Config 3: the sites search at block 8, the tiled search at 16, then
    the fractional warp (tpufg's gate keeps exhaustive MVs off the
    integer-offset path)."""
    cfg = _cfg(hw, hw, motion_mode="exhaustive", block_size=b,
               search_radius=r)
    mv = _mv_and_bytes_match(cfg, *hw, step=r < 16)
    assert mv.shape == (2, hw[0] // 16, hw[1] // 16)
    assert np.abs(mv.numpy()).max() <= r


@pytest.mark.parametrize("kw", [dict(interpolation_factor=0.25),
                                dict(search_radius=9)],
                         ids=["factor-0.25", "radius-9"])
def test_pyramid_fractional_warp_matches_tpufg(kw):
    """The pyramid's MVs through the fractional warp: t != 0.5, or an odd
    warp range that makes the t = 0.5 half-offsets fractional."""
    _mv_and_bytes_match(_cfg((64, 128), (64, 128), **kw), 64, 128)
