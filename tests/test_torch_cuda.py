"""tpufg_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false (decided at run time, never at
import, so every pytest-xdist worker collects the same tests).  On a
machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Small shapes; the full 1080p and 4K shapes are checked by chip_smoke.py.
Tolerances: unpack, box2, both motion searches, the planar Lanczos (f32 and
bf16, the tile walk and the direct stencil), the block warp and the
engine's warp (every mode, f32 and bf16, with and without the crop) bitwise;
packed Lanczos no differing byte (the kernel follows the plain version's tap
order with explicit round-to-nearest operations); MV fields bitwise between
the kernel and plain paths. The convs, relative to max |plain|: the stride-2
conv 2e-5 in both dtypes (the operands round identically, only the order of
the f32 sums differs, in bf16 on the tensor cores); the chain 2e-5 in f32
and tpufg's 3e-2 in bf16 (an intermediate next to a bf16 rounding boundary
may round the other way); the learned step's bytes within 1 code on all but
1e-3 of them.  The quality preset's kernels bitwise too: the per-pixel
(OBMC) warp in single, blend and pair mode, the blend epilogue (occlusion,
MC fallback by cells and per pixel), the block warp's pair mode, and the
engine warp with every option against its plain version, the 4q step's
MV field bitwise between the paths and its bytes within 1 code.  The
engine's options: the y4m egress kernel bitwise to its plain version and
to the host egress, the seeded pyramid's warps and the x4 blends at the
temporal reach bitwise, and the temporal steps (x4 with the scene cut and
the y4m egress; 4q at x3) with their seeds bitwise between the paths and
their bytes within 1 code.  The exact path's two kernels bitwise to
their plain versions (the oracle's scale with its UNORM8 store at 2x,
4:3, identity and a downscale; its warp with a per-pixel MV field past
every edge and as a crossfade, at t in {0.25, 0.5}), and the exact step's
kernel path (the tiled search with the exact box, the warp, the scale)
bitwise to its plain path, MV field and bytes.  RIFE's IFNet: its six kernels
bitwise to their plain versions (the bias and PReLU, also to PyTorch's two
passes, in place and into channel slices; the warp of planar f32 frames
and of channels-last bf16 features into a channel slice, flows past every
edge; the pack, plain and space-to-depth; the merge; the flow and mask
accumulation at each block's scale); its
1080p step against the benchmark's plain reference by the benchmark's own
comparison, within the configuration's ``bad_byte_share`` limit in bf16
and past it in float8 (the reference's control).  RAFT: its kernels
bitwise to their plain versions at 1080p's 1/8 grid (the lookup with
coordinates past every edge of every level; the convex upsampling; the
GRU's two passes), its 1080p -> 4K step with the stream cache bitwise
between the kernel path (the flow as one CUDA graph replay) and the plain
path, with
its launches a pair, and against the benchmark's plain
reference as the IFNet's.  The engine's readback
into pinned host blocks: over 110 frames every output handed over
byte-equal to ``arr.cpu().numpy()`` of the same output, each in a block
of its own (RGBA, the y4m C420 payload, the exact path's uint8 RGBA); no
block made inside a hand-over once warm, one made in the top-up for each
block a sink keeps; the same file bytes through the threaded sink.  The
engine's stateless step replayed from its CUDA graph (configs 4, 4q and 3,
mode none, x3 and ``--scene-cut`` across cuts, at full size, 9 pairs)
bitwise to the eager step, the outputs a device sink kept unchanged by
the later pairs, the kernels' launch counts the eager run's and the
warm-up's.
"""

import contextlib

import numpy as np
import pytest
import torch

from tpufg_torch.config import EngineConfig
from tpufg_torch.engine.pipeline import (exact_mv, interp_planar,
                                         make_exact_scale_step,
                                         make_interp_step, make_q_init)
from tpufg_torch.engine.runner import StreamingEngine
from tpufg_torch.kernels.common import plain_versions
from tpufg_torch.kernels.conv import (conv3x3_chain, conv3x3_chain_plain,
                                      conv3x3_s2, conv3x3_s2_plain, conv_same,
                                      packed_s2_weights)
from tpufg_torch.kernels.convert import frames_to_planar, frames_to_planar_plain
from tpufg_torch.kernels.lanczos import (channel_groups, lanczos_scale_fast,
                                         lanczos_scale_fast_plain,
                                         lanczos_plan, lanczos_scale_packed,
                                         lanczos_scale_packed_plain,
                                         planar_plan)
from tpufg_torch.kernels.motion import (motion_search_sites,
                                        motion_search_sites_plain,
                                        motion_search_tiled,
                                        motion_search_tiled_plain)
from tpufg_torch.io.sinks import AsyncSink, FrameSink, RawVideoSink
from tpufg_torch.io.sources import SyntheticSource
from tpufg_torch.kernels.oracle import (oracle_scale, oracle_scale_plain,
                                        oracle_warp, oracle_warp_plain)
from tpufg_torch.kernels.resize import box_downsample2, box_downsample2_plain
from tpufg_torch.ops import oracle
from tpufg_torch.kernels.warp import warp_blend_block, warp_blend_block_plain
from tpufg_torch.kernels.warp_matmul import (warp_blend_matmul,
                                             warp_blend_matmul_plain,
                                             warp_epilogue,
                                             warp_epilogue_plain, warp_obmc,
                                             warp_obmc_plain, warp_pair_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _bits(x):
    return x.contiguous().view(torch.int32).cpu()


# the kernel path, then the plain path (kernels.common.plain_versions)
PATHS = (contextlib.nullcontext, plain_versions)


def _in(scope, fn, *args):
    with scope():
        return fn(*args)


def _frame(rng, h, w):
    return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)


@pytest.mark.parametrize("hw", [(64, 128), (72, 88)])
@pytest.mark.parametrize("wire", ["u8", "i32"])
def test_unpack_bitwise(cuda, hw, wire):
    f = _frame(np.random.default_rng(0), *hw)
    if wire == "i32":
        f = f.view(np.int32).reshape(hw)
    x = torch.from_numpy(f).to(cuda)
    before = frames_to_planar.launches
    k = frames_to_planar(x)
    torch.cuda.synchronize()
    assert frames_to_planar.launches == before + 1
    assert torch.equal(_bits(k), _bits(frames_to_planar_plain(x)))


@pytest.mark.parametrize("shape", [(4, 64, 128), (3, 34, 60)])
def test_box2_bitwise(cuda, shape):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    before = box_downsample2.launches
    k = box_downsample2(x)
    torch.cuda.synchronize()
    assert box_downsample2.launches == before + 1
    assert torch.equal(_bits(k), _bits(box_downsample2_plain(x)))


@pytest.mark.parametrize("in_hw,out_hw,a", [
    ((64, 128), (128, 256), 3), ((72, 88), (144, 176), 3),
    ((48, 80), (108, 180), 3), ((64, 128), (48, 96), 3),
    # several tiles each way with ragged last tiles, an odd width, 1.333x
    ((150, 400), (300, 801), 3), ((90, 300), (120, 400), 3),
    # smaller than a tile, and an input shorter than the taps
    ((5, 7), (9, 13), 3), ((3, 4), (17, 5), 3),
    # 2 and 8 taps, a = 2 downscaling, a width that is no multiple of 4
    ((64, 128), (128, 256), 1), ((64, 130), (128, 259), 4),
    ((64, 128), (48, 96), 2), ((200, 300), (100, 150), 2),
    # downscales by 2 and more: the plan picks the direct stencil
    ((256, 512), (10, 20), 3)])
def test_lanczos_within_one_code(cuda, in_hw, out_hw, a):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 256, (4, *in_hw)).astype(np.float32)
                         * np.float32(1 / 255)).to(cuda)
    before = lanczos_scale_packed.launches
    k = lanczos_scale_packed(x, *out_hw, a=a)
    torch.cuda.synchronize()
    assert lanczos_scale_packed.launches == before + 1
    p = lanczos_scale_packed_plain(x, *out_hw, a=a)
    assert k.shape == p.shape == (*out_hw, 4)
    d = (k.cpu().to(torch.int16) - p.cpu().to(torch.int16)).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).sum()) <= 1e-4 * d.numel()
    # the kernel keeps the plain version's operations: no byte differs
    assert int((d > 0).sum()) == 0
    direct = lanczos_plan(*in_hw, *out_hw, a).tile_rows == 0
    assert direct == (in_hw[0] >= 2 * out_hw[0])


def test_lanczos_takes_an_unaligned_view(cuda):
    """A frame whose storage does not start on 16 bytes (a view into a
    larger buffer) stages with scalar loads: same bytes."""
    rng = np.random.default_rng(12)
    buf = torch.from_numpy(rng.random(4 * 64 * 128 + 1, dtype=np.float32)
                           ).to(cuda)
    x = buf[1:].view(4, 64, 128)
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    k = lanczos_scale_packed(x, 128, 256)
    assert torch.equal(k.cpu(), lanczos_scale_packed_plain(x, 128, 256).cpu())


@pytest.mark.parametrize("c,in_hw,out_hw,a", [
    (4, (64, 128), (128, 256), 3), (3, (72, 88), (50, 200), 3),
    (1, (32, 128), (96, 96), 3),
    # full groups and a remainder, several tiles with ragged last ones
    (5, (150, 400), (300, 801), 3), (17, (40, 72), (80, 144), 3),
    (5, (90, 300), (120, 400), 2), (17, (64, 128), (96, 200), 2),
    (1, (64, 128), (128, 256), 2), (3, (48, 80), (108, 180), 2),
    (4, (72, 88), (144, 176), 2),
    # downscales on each side of the plan's crossover: by 4/3, 2 and 3 the
    # tiles are walked (fewer channels a block), by 4 and more the direct
    # stencil runs
    (4, (64, 128), (48, 96), 3), (5, (200, 300), (100, 150), 3),
    (5, (240, 402), (80, 134), 3), (4, (256, 1024), (64, 256), 3),
    (3, (256, 512), (10, 20), 3),
    # a width that is no multiple of 4 (scalar staging), 2 and 8 taps
    (4, (64, 130), (128, 259), 3), (5, (33, 70), (70, 141), 4),
    (2, (64, 128), (128, 256), 1)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_lanczos_fast_bitwise(cuda, c, in_hw, out_hw, a, dt):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 256, (c, *in_hw)).astype(np.float32)
                         * np.float32(1 / 255)).to(cuda).to(dt)
    group, plan = planar_plan(c, *in_hw, *out_hw, a)
    direct = plan.tile_rows == 0
    assert direct == (in_hw[0] >= 4 * out_hw[0])
    before = lanczos_scale_fast.launches
    k = lanczos_scale_fast(x, *out_hw, a=a)
    torch.cuda.synchronize()
    # one launch per channel group; the direct stencil loops over channels
    assert lanczos_scale_fast.launches == before + (
        1 if direct else len(channel_groups(c, group)))
    p = lanczos_scale_fast_plain(x, *out_hw, a=a)
    assert k.dtype == p.dtype == dt and k.shape == p.shape == (c, *out_hw)
    assert torch.equal(k.view(torch.int16).cpu(), p.view(torch.int16).cpu())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_lanczos_fast_takes_an_unaligned_view(cuda, dt):
    """A stack whose storage does not start on four values (a view into a
    larger buffer) stages with scalar loads: same values."""
    rng = np.random.default_rng(13)
    buf = torch.from_numpy(rng.random(5 * 64 * 128 + 1, dtype=np.float32)
                           ).to(cuda).to(dt)
    x = buf[1:].view(5, 64, 128)
    assert x.data_ptr() % (4 * x.element_size()) and x.is_contiguous()
    k = lanczos_scale_fast(x, 128, 256)
    p = lanczos_scale_fast_plain(x, 128, 256)
    assert torch.equal(k.view(torch.int16).cpu(), p.view(torch.int16).cpu())


@pytest.mark.parametrize("c,h,w,g,r", [(4, 64, 256, 16, 16),
                                       (3, 32, 128, 8, 8),
                                       # g = 12; a g the cell width does not
                                       # divide (the one-pixel walk), C > 4
                                       (4, 36, 60, 12, 8), (4, 40, 50, 10, 6),
                                       (6, 32, 64, 16, 8)])
@pytest.mark.parametrize("kw", [dict(factor=0.5), dict(factor=0.25),
                                dict(factor=1.0), dict(single=True)],
                         ids=["t0.5", "t0.25", "t1", "single"])
def test_warp_block_bitwise(cuda, c, h, w, g, r, kw):
    rng = np.random.default_rng(10)
    prev, curr = (torch.from_numpy(rng.integers(0, 256, (c, h, w)).astype(
        np.float32) * np.float32(1 / 255)).to(cuda) for _ in range(2))
    # quarter-pel MVs past +-r, so the clip and the blanked borders run
    mv = torch.from_numpy((rng.integers(-4 * r - 8, 4 * r + 9,
                                        (2, h // g, w // g)) / 4).astype(
        np.float32)).to(cuda)
    before = warp_blend_block.launches
    k = warp_blend_block(prev, curr, mv, block=g, search_radius=r, **kw)
    torch.cuda.synchronize()
    assert warp_blend_block.launches == before + 1
    p = warp_blend_block_plain(prev, curr, mv, block=g, search_radius=r,
                               **kw)
    assert k.shape == p.shape == (c, h, w)
    assert torch.equal(_bits(k), _bits(p))


# the engine warp's modes: (single, integer offsets, u8_exact)
WARP_MODES = {"blend-int-u8": (False, True, True),   # config 4's blend
              "blend-int": (False, True, False),
              "blend-frac": (False, False, True),    # config 3's
              "single-int": (True, True, False),     # refine, coarse warp
              "single-frac": (True, False, False)}   # config 5's tail


def _warp_case(cuda, mode, c, h, w, g, r, seed):
    """Code-valued frames and MVs past the clip (even where a blend must
    move whole pixels), the border blocks pointing out of the frame."""
    single, integer, _ = WARP_MODES[mode]
    rng = np.random.default_rng(seed)
    prev, curr = (torch.from_numpy(rng.integers(0, 256, (c, h, w)).astype(
        np.float32) * np.float32(1 / 255)).to(cuda) for _ in range(2))
    lim = 2 * r + 6
    if integer:
        mv = rng.integers(-lim, lim + 1, (2, h // g, w // g)) * (
            1 if single else 2)
    else:
        # continuous: the fractions round to bf16, as real flows' do
        mv = rng.uniform(-lim, lim, (2, h // g, w // g))
    mv[0, :, 0], mv[0, :, -1] = -lim, lim
    mv[1, 0, :], mv[1, -1, :] = -lim, lim
    return prev, curr, torch.from_numpy(mv.astype(np.float32)).to(cuda)


WARP_SHAPES = [
    (4, 64, 256, 16, 16, 0.5, None), (3, 40, 96, 8, 4, 0.5, None),
    # g = 12, a g the cell width does not divide, C > 4
    (4, 48, 96, 12, 8, 0.5, None), (4, 40, 60, 10, 6, 0.5, None),
    (5, 32, 64, 16, 8, 0.5, None),
    # the engine's crop (1080 of 1088 rows), and a ragged window
    (4, 64, 128, 16, 16, 0.5, (56, 128)), (4, 64, 128, 16, 8, 0.5, (61, 117))]


@pytest.mark.parametrize("mode,c,h,w,g,r,t,crop", [
    (mode, *shape) for mode in WARP_MODES for shape in WARP_SHAPES] + [
    # t != 1/2 moves fractional offsets only
    (mode, 4, 64, 256, 16, 16, t, None) for mode in ("blend-frac",
                                                     "single-frac")
    for t in (0.25, 0.7)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_warp_matmul_bitwise(cuda, mode, dt, c, h, w, g, r, t, crop):
    single, integer, u8 = WARP_MODES[mode]
    prev, curr, mv = _warp_case(cuda, mode, c, h, w, g, r, h + w + g)
    kw = dict(factor=t, block=g, search_radius=r, single=single, dtype=dt,
              integer_offsets=integer, u8_exact=u8)
    before = warp_blend_matmul.launches
    k = warp_blend_matmul(prev, curr, mv, crop=crop, **kw)
    torch.cuda.synchronize()
    assert warp_blend_matmul.launches == before + 1
    p = warp_blend_matmul_plain(prev, curr, mv, crop=crop, **kw)
    assert k.shape == p.shape and k.is_contiguous()
    assert torch.equal(_bits(k), _bits(p))


def test_warp_matmul_rejects_bad_input(cuda):
    x = torch.zeros((4, 64, 128), device=cuda)
    mv = torch.zeros((2, 4, 8), device=cuda)
    before = warp_blend_matmul.launches
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, torch.zeros((2, 4, 7), device=cuda))
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, mv.cpu())                  # mv on the CPU
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x.cpu(), mv)                  # curr on the CPU
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x[:3], mv)                    # shapes differ
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, mv, crop=(65, 128))        # past the frame
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, mv, dtype=torch.float16)
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, mv, search_radius=200)     # tpufg's reach
    with pytest.raises(ValueError):
        warp_blend_matmul(x, x, mv, bilinear=True, integer_offsets=True)
    assert warp_blend_matmul.launches == before


def test_kernel_rejects_bad_input(cuda):
    x = torch.zeros((4, 64, 128), device=cuda)
    with pytest.raises(ValueError):
        box_downsample2(x[:, :, ::2])  # not contiguous
    with pytest.raises(ValueError):
        lanczos_scale_packed(x[:3], 128, 256)
    with pytest.raises(ValueError):
        frames_to_planar(torch.zeros((8, 8, 3), dtype=torch.uint8,
                                     device=cuda))
    before = (lanczos_scale_fast.launches, warp_blend_block.launches)
    with pytest.raises(ValueError):
        lanczos_scale_fast(x.half(), 128, 256)
    with pytest.raises(ValueError):
        lanczos_scale_fast(x, 128, 256, a=5)
    with pytest.raises(ValueError):
        warp_blend_block(x, x, torch.zeros((2, 4, 7), device=cuda))
    with pytest.raises(ValueError):
        warp_blend_block(x, x, torch.zeros((2, 4, 8)))   # mv on the CPU
    assert (lanczos_scale_fast.launches,
            warp_blend_block.launches) == before


def test_step_kernel_path_matches_plain_path(cuda):
    from tpufg_torch.io.sources import SyntheticSource
    h, w = 128, 256
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=2)]
    mvs = []
    for scope in PATHS:
        with scope():
            _, mv = interp_planar(frames_to_planar(frames[0]),
                                  frames_to_planar(frames[1]),
                                  mode="pyramid", factors=[0.5],
                                  dt=torch.bfloat16, block_size=8,
                                  search_radius=16, return_mv=True)
        mvs.append(mv)
    assert torch.equal(_bits(mvs[0]), _bits(mvs[1]))
    cfg = EngineConfig(input_width=w, input_height=h, output_width=2 * w,
                       output_height=2 * h)
    outs = [_in(scope, make_interp_step(cfg, wire="i32", device=cuda),
                *frames) for scope in PATHS]
    for a, b in zip(*outs):
        d = (a.cpu().view(torch.uint8).to(torch.int16)
             - b.cpu().view(torch.uint8).to(torch.int16)).abs()
        assert int(d.max()) <= 1


def _moved_pair(rng, cuda, c, h, w):
    """prev and curr = prev moved by (-2, 3), with unrelated rows on top."""
    prev = rng.integers(0, 256, (c, h, w)).astype(np.float32) / 255
    curr = np.roll(prev, (3, -2), (1, 2))
    curr[:, :8] = rng.integers(0, 256, (c, 8, w)) / 255
    return (torch.from_numpy(prev.astype(np.float32)).to(cuda),
            torch.from_numpy(curr.astype(np.float32)).to(cuda))


@pytest.mark.parametrize("c,h,w,r", [(4, 64, 256, 4), (3, 96, 384, 8),
                                     (4, 128, 300, 16),
                                     # one strip exactly, one column more,
                                     # a frame narrower than a strip
                                     (3, 64, 121, 4), (4, 32, 122, 16),
                                     (4, 48, 50, 5),
                                     # radii that are no multiple of the dy
                                     # block, r = 0, one site row, C = 3 wide
                                     (3, 32, 200, 1), (4, 32, 130, 0),
                                     (4, 16, 260, 7), (3, 16, 700, 2),
                                     (3, 64, 500, 16)])
def test_motion_sites_bitwise(cuda, c, h, w, r):
    prev, curr = _moved_pair(np.random.default_rng(3), cuda, c, h, w)
    before = motion_search_sites.launches
    k = motion_search_sites(prev, curr, search_radius=r, dx_chunk=1)
    torch.cuda.synchronize()
    assert motion_search_sites.launches == before + 1
    p = motion_search_sites_plain(prev, curr, search_radius=r)
    assert k.shape == p.shape == (2, h // 16, w)
    assert torch.equal(_bits(k), _bits(p))


@pytest.mark.parametrize("c,h,w,b,r,exact", [(4, 24, 40, 4, 4, True),
                                             (3, 40, 24, 8, 4, False),
                                             (4, 64, 200, 12, 4, False),
                                             (4, 32, 64, 16, 2, True),
                                             # C = 3 at the compiled-in sizes
                                             (3, 48, 150, 12, 4, False),
                                             (3, 40, 130, 16, 3, False),
                                             (3, 33, 70, 16, 2, True),
                                             # odd radii, a frame narrower
                                             # than a tile, ragged last rows
                                             (4, 50, 37, 8, 5, True),
                                             (4, 21, 19, 16, 7, False),
                                             (4, 70, 260, 6, 3, False),
                                             (4, 96, 240, 16, 16, False)])
def test_motion_tiled_bitwise(cuda, c, h, w, b, r, exact):
    prev, curr = _moved_pair(np.random.default_rng(4), cuda, c, h, w)
    before = motion_search_tiled.launches
    k = motion_search_tiled(prev, curr, block_size=b, search_radius=r,
                            exact_box=exact)
    torch.cuda.synchronize()
    assert motion_search_tiled.launches == before + 1
    p = motion_search_tiled_plain(prev, curr, b, r, exact_box=exact)
    assert k.shape == p.shape == (2, h, w)
    assert torch.equal(_bits(k), _bits(p))


def test_motion_kernels_reject_unsupported(cuda):
    x5 = torch.zeros((5, 64, 128), device=cuda)
    x = torch.zeros((4, 64, 128), device=cuda)
    before = (motion_search_sites.launches, motion_search_tiled.launches)
    with pytest.raises(ValueError, match="channels"):
        motion_search_sites(x5, x5, search_radius=4, dx_chunk=1)
    with pytest.raises(ValueError, match="channels"):
        motion_search_tiled(x5, x5, search_radius=4)
    with pytest.raises(ValueError, match="shared memory"):
        motion_search_tiled(x, x, block_size=64, search_radius=64)
    with pytest.raises(ValueError, match="block_size=8"):
        motion_search_sites(x, x, block_size=4)
    assert (motion_search_sites.launches,
            motion_search_tiled.launches) == before


@pytest.mark.parametrize("b", [8, 16])
def test_exhaustive_kernel_path_matches_plain_path(cuda, b):
    from tpufg_torch.io.sources import SyntheticSource
    h, w = 128, 256
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=2)]
    outs = []
    for scope in PATHS:
        with scope():
            mid, mv = interp_planar(frames_to_planar(frames[0]),
                                    frames_to_planar(frames[1]),
                                    mode="exhaustive", factors=[0.5],
                                    dt=torch.bfloat16, block_size=b,
                                    search_radius=16, return_mv=True)
        outs.append((mid[0], mv))
    assert torch.equal(_bits(outs[0][1]), _bits(outs[1][1]))
    assert torch.equal(_bits(outs[0][0]), _bits(outs[1][0]))


def _rel(k, p):
    return float((k - p).abs().max() / p.abs().max())


@pytest.mark.parametrize("cin,h,w,cout", [
    (4, 64, 128, 32), (8, 60, 140, 32), (4, 34, 250, 32),
    # Cout < 32 (whole n8 tiles skipped, and a ragged one), tiles ragged
    # both ways, a width that is no multiple of 4, a frame below one tile
    (4, 36, 300, 20), (8, 50, 270, 5), (4, 130, 518, 32), (8, 6, 10, 32),
    (4, 2, 2, 1)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_s2_kernel_matches_plain(cuda, cin, h, w, cout, dt):
    rng = np.random.default_rng(cin + h)
    x = torch.from_numpy(rng.random((cin, h, w), np.float32)).to(cuda)
    wt = torch.from_numpy(rng.normal(0, .2, (cout, cin, 3, 3))
                          .astype(np.float32)).to(cuda)
    # biases near 1: a channel or border that missed its bias would show
    b = torch.from_numpy(rng.normal(1, .1, (cout,)).astype(np.float32)
                         ).to(cuda)
    before = conv3x3_s2.launches
    k = conv3x3_s2(x, wt, b, compute_dtype=dt)
    torch.cuda.synchronize()
    assert conv3x3_s2.launches == before + 1
    p = conv3x3_s2_plain(x, wt, b, compute_dtype=dt)
    assert k.shape == p.shape == (cout, h // 2, w // 2)
    assert _rel(k, p) <= 2e-5


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_s2_packs_per_weight_set(cuda, dt):
    """Two weight sets in turns and an in-place update: each call computes
    with the weights it was given, though the packed weights are cached,
    and a call with cached weights launches nothing but the kernel."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.random((4, 40, 72), np.float32)).to(cuda)
    sets = [(torch.from_numpy(rng.normal(0, .2, (32, 4, 3, 3))
                              .astype(np.float32)).to(cuda),
             torch.from_numpy(rng.normal(0, .1, (32,)).astype(np.float32)
                              ).to(cuda)) for _ in range(2)]
    for wt, b in (sets[0], sets[1], sets[0]):
        assert _rel(conv3x3_s2(x, wt, b, compute_dtype=dt),
                    conv3x3_s2_plain(x, wt, b, compute_dtype=dt)) <= 2e-5
    wt, b = sets[0]
    assert packed_s2_weights(wt, b, dt, cuda) is packed_s2_weights(wt, b, dt,
                                                                   cuda)
    wt.mul_(0.5)
    b.add_(1.0)
    assert _rel(conv3x3_s2(x, wt, b, compute_dtype=dt),
                conv3x3_s2_plain(x, wt, b, compute_dtype=dt)) <= 2e-5
    assert _rel(conv3x3_s2(x, *sets[1], compute_dtype=dt),
                conv3x3_s2_plain(x, wt, b, compute_dtype=dt)) > 0.3


@pytest.mark.parametrize("chans,relus,h,w", [
    ([17, 64, 64, 5], (True, True, False), 40, 72),
    ([13, 16, 16, 5], (True, True, False), 33, 130),
    ([8, 6], (False,), 24, 256),
    ([4, 12, 3], (True, False), 17, 45),
    # Cin 13 at the head's widths; 1 and 2 layers; sizes that are no
    # multiple of the 8 x 32 tile, and one smaller than a tile
    ([13, 64, 64, 5], (True, True, False), 29, 75),
    ([17, 64], (True,), 19, 50),
    ([13, 64, 5], (True, False), 26, 67),
    ([17, 64, 64, 5], (True, True, False), 5, 21),
    ([24, 48, 40, 7], (False, True, True), 23, 41)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_chain_kernel_matches_plain(cuda, chans, relus, h, w, dt):
    rng = np.random.default_rng(len(chans) + h)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    x = t(rng.standard_normal((chans[0], h, w)))
    ws = [t(rng.standard_normal((chans[i + 1], chans[i], 3, 3)) * 0.2)
          for i in range(len(relus))]
    # positive biases: a border leak of relu(bias) would show
    bs = [t(rng.standard_normal((chans[i + 1],)) * 0.1 + 1.0)
          for i in range(len(relus))]
    before = conv3x3_chain.launches
    k = conv3x3_chain(x, ws, bs, relus, compute_dtype=dt)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches == before + 1
    p = conv3x3_chain_plain(x, ws, bs, relus, compute_dtype=dt)
    assert k.shape == p.shape == (chans[-1], h, w)
    assert _rel(k, p) <= (2e-5 if dt == torch.float32 else 3e-2)


def test_conv_chain_packs_per_weight_set(cuda):
    """Two weight sets in a row, then the first again and an in-place
    update: each call computes with the weights it was given, though the
    packed weights are cached."""
    rng = np.random.default_rng(11)
    chans = [17, 64, 64, 5]

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    x = t(rng.standard_normal((17, 30, 70)))
    sets = [([t(rng.standard_normal((chans[i + 1], chans[i], 3, 3)) * 0.1)
              for i in range(3)],
             [t(rng.standard_normal((chans[i + 1],)) * 0.1)
              for i in range(3)]) for _ in range(2)]
    relus = (True, True, False)
    before = conv3x3_chain.launches
    for ws, bs in (sets[0], sets[1], sets[0]):
        k = conv3x3_chain(x, ws, bs, relus)
        assert _rel(k, conv3x3_chain_plain(x, ws, bs, relus)) <= 3e-2
    ws, bs = sets[0]
    ws[1].mul_(0.5)
    bs[2].add_(1.0)
    k = conv3x3_chain(x, ws, bs, relus)
    torch.cuda.synchronize()
    assert conv3x3_chain.launches == before + 4
    assert _rel(k, conv3x3_chain_plain(x, ws, bs, relus)) <= 3e-2
    # the two sets do differ by far more than the bound
    assert _rel(conv3x3_chain(x, *sets[1], relus),
                conv3x3_chain_plain(x, ws, bs, relus)) > 0.3


def test_conv_kernels_reject_unsupported(cuda):
    x = torch.zeros((5, 64, 128), device=cuda)
    before = (conv3x3_s2.launches, conv3x3_chain.launches)
    with pytest.raises(ValueError, match="Cin"):
        conv3x3_s2(x, torch.zeros((32, 5, 3, 3), device=cuda),
                   torch.zeros((32,), device=cuda))
    w = torch.zeros((5, 5, 3, 3), device=cuda)
    b = torch.zeros((5,), device=cuda)
    with pytest.raises(ValueError, match="at most 3"):
        conv3x3_chain(x, [w] * 4, [b] * 4, (True,) * 4)
    with pytest.raises(ValueError, match="up to 64 channels"):
        conv3x3_chain(x, [torch.zeros((80, 5, 3, 3), device=cuda)],
                      [torch.zeros((80,), device=cuda)], (True,))
    assert (conv3x3_s2.launches, conv3x3_chain.launches) == before


def test_conv_same_runs_f32_without_tf32(cuda):
    """An f32 conv through cuDNN must not keep only TF32's 10 mantissa
    bits: held to a float64 conv at f32 accuracy, and the global flag is
    left as it was."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 40, 72))
    w = rng.standard_normal((64, 64, 3, 3)) * 0.05
    b = np.zeros(64)
    flag = torch.backends.cudnn.allow_tf32
    got = conv_same(torch.from_numpy(x).float().to(cuda),
                    torch.from_numpy(w).float().to(cuda),
                    torch.from_numpy(b).float().to(cuda), 1).cpu().double()
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.float32)).double()[None],
        torch.from_numpy(w.astype(np.float32)).double(), padding=1)[0]
    assert torch.backends.cudnn.allow_tf32 == flag
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_learned_step_kernel_path_matches_plain_path(cuda):
    from tpufg_torch.io.sources import SyntheticSource
    from tpufg_torch.engine.pipeline import make_q_init
    from tpufg_torch.models import rife
    h, w = 96, 160
    params = rife.load_params(rife.bundled_checkpoint())
    cfg = EngineConfig(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="learned")
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=2)]
    outs = []
    for scope in PATHS:
        before = (conv3x3_s2.launches, conv3x3_chain.launches,
                  warp_blend_matmul.launches)
        with scope():
            q = make_q_init(cfg, params, cuda)(frames[0])
            step = make_interp_step(cfg, wire="i32", device=cuda,
                                    model_params=params, q_feed=True)
            outs.append(step(*frames, q))
        torch.cuda.synchronize()
        grew = (conv3x3_s2.launches - before[0],
                conv3x3_chain.launches - before[1],
                warp_blend_matmul.launches - before[2])
        # the kernel path: two coarse warps and two tail warps per pair
        assert grew == ((0, 0, 0) if scope is plain_versions
                        else (2, 1, 4))
    (mid_k, curr_k, q_k), (mid_p, curr_p, q_p) = outs
    assert torch.equal(curr_k, frames[1]) and torch.equal(curr_p, frames[1])
    assert torch.equal(q_k[0], q_p[0])
    d = (mid_k.cpu().view(torch.uint8).to(torch.int16)
         - mid_p.cpu().view(torch.uint8).to(torch.int16)).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).sum()) <= 1e-3 * d.numel()


# the per-pixel warp's cases: (C, H, W, g, r); W = 96 is taken as given
# (the engine warp pads it, warp_obmc does not)
OBMC_SHAPES = [(4, 64, 256, 8, 16), (3, 48, 128, 16, 8), (4, 40, 96, 8, 4)]


@pytest.mark.parametrize("mode", ["single", "blend", "pair"])
@pytest.mark.parametrize("c,h,w,g,r", OBMC_SHAPES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_warp_obmc_bitwise(cuda, mode, dt, c, h, w, g, r):
    prev, curr, mv = _warp_case(cuda, "blend-frac", c, h, w, g, r, h + g)
    crop = (h - 3, w - 5) if mode == "blend" else None
    kw = dict(block=g, search_radius=r, single=mode == "single", dtype=dt,
              pair=mode == "pair", crop=crop)
    before = warp_obmc.launches
    k = warp_obmc(prev, curr, mv, **kw)
    torch.cuda.synchronize()
    assert warp_obmc.launches == before + 1
    p = warp_obmc_plain(prev, curr, mv, **kw)
    assert k.shape == p.shape and k.is_contiguous()
    assert torch.equal(_bits(k), _bits(p))


@pytest.mark.parametrize("occlusion,fallback", [(True, False), (False, True),
                                                (True, True), (False, False)])
@pytest.mark.parametrize("t", [0.5, 0.25, 0.7])
@pytest.mark.parametrize("hw", [(64, 128), (36, 60)])   # 36 x 60: per pixel
def test_warp_epilogue_bitwise(cuda, occlusion, fallback, t, hw):
    h, w = hw
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, h, w, 4, 4, h + w)
    pair = warp_pair_plain(prev, curr, mv, factor=t, block=4,
                           search_radius=4)
    kw = dict(factor=t, occlusion=occlusion, mc_fallback=fallback,
              crop=(h - 4, w - 1))
    before = warp_epilogue.launches
    k = warp_epilogue(pair, prev, curr, **kw)
    torch.cuda.synchronize()
    cells = fallback and h % 8 == 0 and w % 8 == 0
    assert warp_epilogue.launches == before + 1 + cells
    p = warp_epilogue_plain(pair, prev, curr, **kw)
    assert k.shape == p.shape == (4, h - 4, w - 1)
    assert torch.equal(_bits(k), _bits(p))


# the tile walks' edges (csrc/warp_obmc.cu: tiles of 32 columns x 16 rows;
# csrc/warp_epilogue.cu: cells in strips of 256 columns, the blend in
# tiles of 128 x 8): widths that are not a multiple of a tile's or a
# strip's, heights that are not a multiple of 16, and g = 16, whose first
# and last 8 rows (half a band) take a tile's first half
OBMC_EDGES = [(4, 40, 200, 8, 16), (4, 48, 336, 16, 8), (3, 80, 144, 16, 16),
              (4, 56, 264, 8, 4)]


@pytest.mark.parametrize("mode", ["single", "blend", "pair", "cells"])
@pytest.mark.parametrize("c,h,w,g,r", OBMC_EDGES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_warp_obmc_tile_edges_bitwise(cuda, mode, dt, c, h, w, g, r):
    """Each mode at the walk's edges; mode "cells" is the pair and the
    fallback's cell means in one launch."""
    prev, curr, mv = _warp_case(cuda, "blend-frac", c, h, w, g, r, h + w)
    pair = mode in ("pair", "cells")
    crop = None if pair else (h - 5, w - 3)
    kw = dict(factor=0.25 if mode == "blend" else 0.5, block=g,
              search_radius=r, single=mode == "single", dtype=dt,
              pair=pair, crop=crop, valid_w=w - 8, cells=mode == "cells")
    before = warp_obmc.launches
    k = warp_obmc(prev, curr, mv, **kw)
    torch.cuda.synchronize()
    assert warp_obmc.launches == before + 1
    p = warp_obmc_plain(prev, curr, mv, **kw)
    for kk, pp in zip(*((k, p) if mode == "cells" else ((k,), (p,)))):
        assert kk.shape == pp.shape
        assert torch.equal(_bits(kk), _bits(pp))


def _epilogue_case(cuda, c, h, w, seed, offset=0):
    """A pair of code values with 0/1 masks, and prev and curr; with
    ``offset`` every operand starts that many floats into its storage (a
    view the kernel must not take 16-byte loads from)."""
    rng = np.random.default_rng(seed)

    def put(a):
        buf = torch.empty(a.size + offset, device=cuda)
        buf[offset:] = torch.from_numpy(a.reshape(-1)).to(cuda)
        return buf[offset:].view(a.shape)

    codes = rng.integers(0, 256, (3 * c + 2, h, w)).astype(np.float32)
    codes *= np.float32(1 / 255)
    codes[2 * c:2 * c + 2] = rng.integers(0, 2, (2, h, w))
    return (put(codes[:2 * c + 2]), put(codes[2 * c + 2:3 * c + 2]),
            put(codes[:c][::-1].copy()))


@pytest.mark.parametrize("occlusion,fallback", [(True, True), (False, True),
                                                (True, False)])
@pytest.mark.parametrize("h,w,crop,offset", [
    (40, 264, (37, 261), 0),     # a strip of 32 cells and one of 1
    (48, 520, (48, 517), 0),     # two strips and one cell
    (24, 64, (21, 64), 1),       # operands off 16-byte alignment
    (36, 62, (36, 61), 0)])      # W % 4 != 0: per pixel, scalar access
def test_warp_epilogue_tile_edges_bitwise(cuda, occlusion, fallback, h, w,
                                          crop, offset):
    pair, prev, curr = _epilogue_case(cuda, 4, h, w, h + w, offset)
    kw = dict(factor=0.5, occlusion=occlusion, mc_fallback=fallback,
              crop=crop)
    k = warp_epilogue(pair, prev, curr, **kw)
    p = warp_epilogue_plain(pair, prev, curr, **kw)
    assert k.shape == p.shape == (4,) + crop
    assert torch.equal(_bits(k), _bits(p))


def test_warp_obmc_4q_shape_bitwise(cuda):
    """Config 4q's per-pixel warp at its shape: the padded 1080p frame on
    the 8-px lattice, pair mode with the cell means, bf16."""
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, 1088, 1920, 8, 16, 4)
    kw = dict(block=8, search_radius=16, dtype=torch.bfloat16, pair=True,
              cells=True)
    for k, p in zip(warp_obmc(prev, curr, mv, **kw),
                    warp_obmc_plain(prev, curr, mv, **kw)):
        assert torch.equal(_bits(k), _bits(p))


@pytest.mark.parametrize("given", [False, True], ids=["cells pass", "given"])
def test_warp_epilogue_4q_shape_bitwise(cuda, given):
    """Config 4q's epilogue at its shape: occlusion and the fallback by
    cells on the padded 1080p pair, cropped to 1080 rows; its own cells
    pass, or the cell means given (one launch)."""
    from tpufg_torch.kernels.warp_matmul import fallback_cells_plain
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, 1088, 1920, 8, 16, 5)
    pair = warp_pair_plain(prev, curr, mv, block=8, search_radius=16,
                           dtype=torch.bfloat16, bilinear=True)
    kw = dict(factor=0.5, occlusion=True, mc_fallback=True, crop=(1080, 1920))
    cells = fallback_cells_plain(pair, prev, curr) if given else None
    before = warp_epilogue.launches
    k = warp_epilogue(pair, prev, curr, cells=cells, **kw)
    torch.cuda.synchronize()
    assert warp_epilogue.launches == before + 2 - given
    assert torch.equal(_bits(k),
                       _bits(warp_epilogue_plain(pair, prev, curr, **kw)))


@pytest.mark.parametrize("bilinear,g", [(True, 8), (False, 16), (False, 8)])
@pytest.mark.parametrize("occlusion,fallback", [(True, True), (True, False),
                                                (False, True)])
@pytest.mark.parametrize("w", [256, 192])   # 192: tpufg's column pad
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_warp_matmul_options_bitwise(cuda, bilinear, g, occlusion, fallback,
                                     w, dt):
    h = 64
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, h, w, g, 16, g + w)
    kw = dict(factor=0.5, block=g, search_radius=16, dtype=dt, u8_exact=True,
              bilinear=bilinear, occlusion=occlusion, mc_fallback=fallback,
              crop=(h - 8, w))
    before = (warp_blend_matmul.launches, warp_obmc.launches,
              warp_epilogue.launches)
    k = warp_blend_matmul(prev, curr, mv, **kw)
    torch.cuda.synchronize()
    grew = (warp_blend_matmul.launches - before[0],
            warp_obmc.launches - before[1],
            warp_epilogue.launches - before[2])
    # the per-pixel warp makes the fallback's cell means in its launch
    assert grew == (int(not bilinear), int(bilinear),
                    1 + int(fallback and not bilinear))
    p = warp_blend_matmul_plain(prev, curr, mv, **kw)
    assert k.shape == p.shape == (4, h - 8, w)
    assert torch.equal(_bits(k), _bits(p))


def test_block_pair_mode_bitwise(cuda):
    """The block walk's pair mode writes the blend's operands: warp_pair
    of csrc/warp_matmul.cu against the plain pair."""
    from tpufg_torch.kernels.warp_matmul import _launch_block
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, 64, 256, 16, 16, 3)
    for integer in (False, True):
        m = torch.round(mv / 2) * 2 if integer else mv
        k = torch.empty((10, 64, 256), device=cuda)
        _launch_block(prev, curr, m, k, 16, 16, 0.5, False, integer, True,
                      torch.bfloat16, True)
        p = warp_pair_plain(prev, curr, m, 0.5, 16, 16, torch.bfloat16,
                            integer, False, True)
        assert torch.equal(_bits(k), _bits(p))


def test_quality_step_kernel_path_matches_plain_path(cuda):
    """Config 4q (the quality preset with --occlusion-blend) at a small
    size: the MV field bitwise, the bytes within 1 code."""
    from tpufg_torch.io.sources import SyntheticSource
    h, w = 128, 256
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=2, velocity=(3, 1))]
    q = dict(mv_grid=1, subpel=True, mv_bias=0.1, mv_filter=True,
             mc_fallback=True, occlusion_blend=True)
    mvs = []
    for scope in PATHS:
        with scope():
            _, mv = interp_planar(frames_to_planar(frames[0]),
                                  frames_to_planar(frames[1]),
                                  mode="pyramid", factors=[0.5],
                                  dt=torch.bfloat16, block_size=8,
                                  search_radius=16, return_mv=True, **q)
        mvs.append(mv)
    assert torch.equal(_bits(mvs[0]), _bits(mvs[1]))
    cfg = EngineConfig(input_width=w, input_height=h, output_width=2 * w,
                       output_height=2 * h, **q)
    outs = [_in(scope, make_interp_step(cfg, wire="i32", device=cuda),
                *frames) for scope in PATHS]
    for a, b in zip(*outs):
        d = (a.cpu().view(torch.uint8).to(torch.int16)
             - b.cpu().view(torch.uint8).to(torch.int16)).abs()
        assert int(d.max()) <= 1


# ---- the engine options: the y4m egress kernel, the seeded warps and the
# x4 blends, the temporal step

@pytest.mark.parametrize("chroma", ["420", "444"])
@pytest.mark.parametrize("hw,aligned", [((64, 128), True), ((72, 88), True),
                                        ((8, 6), True), ((64, 128), False)])
def test_yuv_bitwise(cuda, chroma, hw, aligned):
    """The payload kernel (16-byte walk, and the scalar walk for widths
    that 4 does not divide or a frame off 16-byte alignment) against its
    plain version and the host egress."""
    from tpufg_torch.io.sinks import _down2x2, _rgb_to_bt601
    from tpufg_torch.kernels.yuv import (rgba_to_y4m_payload,
                                         rgba_to_y4m_payload_plain)
    h, w = hw
    f = _frame(np.random.default_rng(h + w), h, w)
    wire = np.concatenate([[0], f.view(np.int32).ravel()]).astype(np.int32)
    x = torch.from_numpy(wire).to(cuda)
    x = (x[1:] if not aligned else x[1:].clone()).view(h, w)
    before = rgba_to_y4m_payload.launches
    k = rgba_to_y4m_payload(x, chroma)
    torch.cuda.synchronize()
    assert rgba_to_y4m_payload.launches == before + 1
    assert torch.equal(k, rgba_to_y4m_payload_plain(x, chroma))
    y, u, v = _rgb_to_bt601(f[..., :3])
    if chroma == "420":
        u, v = _down2x2(u), _down2x2(v)
    host = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
    np.testing.assert_array_equal(k.cpu().numpy().ravel(), host)


def test_seeded_single_warp_bitwise(cuda):
    """The seeded pyramid's warps: fractional single mode at the coarse
    reach (12) and at the refine's 54, the limit."""
    for g, r, (h, w) in ((16, 12, (64, 128)), (16, 54, (128, 256))):
        rng = np.random.default_rng(r)
        prev = torch.from_numpy(rng.integers(0, 256, (4, h, w)).astype(
            np.float32) * np.float32(1 / 255)).to(cuda)
        mv = torch.from_numpy(rng.uniform(-r - 4, r + 4, (2, h // g, w // g))
                              .astype(np.float32)).to(cuda)
        kw = dict(block=g, search_radius=r, single=True)
        k = warp_blend_matmul(prev, prev, mv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(k), _bits(warp_blend_matmul_plain(
            prev, prev, mv, **kw)))


@pytest.mark.parametrize("t", [0.25, 0.75])
def test_x4_blend_bitwise(cuda, t):
    """The engine's x4 blend: fractional, bf16, u8_exact (ignored there),
    cropped, at the temporal reach 72 (54 a side at t = 1/4)."""
    prev, curr, mv = _warp_case(cuda, "blend-frac", 4, 64, 128, 16, 72, 11)
    kw = dict(factor=t, block=16, search_radius=72, dtype=torch.bfloat16,
              u8_exact=True, crop=(56, 128))
    k = warp_blend_matmul(prev, curr, mv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(k), _bits(warp_blend_matmul_plain(
        prev, curr, mv, **kw)))


def test_temporal_x4_step_kernel_path_matches_plain_path(cuda):
    """The temporal x4 step with --scene-cut and the y4m egress: the seed
    bitwise between the paths over four pairs of a pan, the payloads
    within 1 code."""
    from tpufg_torch.engine.pipeline import mv_lattice_shape
    from tpufg_torch.io.sources import SyntheticSource
    h, w = 128, 256
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=5,
                                       velocity=(9.0, 3.0))]
    cfg = EngineConfig(input_width=w, input_height=h, output_width=2 * w,
                       output_height=2 * h, fps_multiplier=4,
                       temporal_mv=True, scene_cut_threshold=0.1)
    step = make_interp_step(cfg, wire="i32", sink_wire="y4m420", device=cuda)
    mv = {path: torch.zeros(mv_lattice_shape(cfg), device=cuda)
          for path in ("kernel", "plain")}
    for i in range(4):
        outs = {}
        for path, scope in zip(mv, PATHS):
            *outs[path], mv[path] = _in(scope, step, frames[i],
                                        frames[i + 1], mv[path])
        assert torch.equal(_bits(mv["kernel"]), _bits(mv["plain"]))
        assert len(outs["kernel"]) == 4
        for a, b in zip(outs["kernel"], outs["plain"]):
            assert a.dtype == torch.uint8 and a.shape == (3 * h, 2 * w)
            d = (a.cpu().to(torch.int16) - b.cpu().to(torch.int16)).abs()
            assert int(d.max()) <= 1


def test_4q_temporal_step_kernel_path_matches_plain_path(cuda):
    """The quality preset with the temporal seed at x3: the seed bitwise
    between the paths over three pairs, the bytes within 1 code."""
    from tpufg_torch.engine.pipeline import mv_lattice_shape
    from tpufg_torch.io.sources import SyntheticSource
    h, w = 128, 256
    frames = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
              for f in SyntheticSource(w, h, n_frames=4,
                                       velocity=(7.0, 2.0))]
    cfg = EngineConfig(input_width=w, input_height=h, output_width=w,
                       output_height=h, fps_multiplier=3, temporal_mv=True,
                       mv_grid=1, subpel=True, mv_bias=0.1, mv_filter=True,
                       mc_fallback=True, occlusion_blend=True)
    step = make_interp_step(cfg, wire="i32", device=cuda)
    mv = {path: torch.zeros(mv_lattice_shape(cfg), device=cuda)
          for path in ("kernel", "plain")}
    for i in range(3):
        outs = {}
        for path, scope in zip(mv, PATHS):
            *outs[path], mv[path] = _in(scope, step, frames[i],
                                        frames[i + 1], mv[path])
        assert torch.equal(_bits(mv["kernel"]), _bits(mv["plain"]))
        for a, b in zip(outs["kernel"], outs["plain"]):
            d = (a.cpu().view(torch.uint8).to(torch.int16)
                 - b.cpu().view(torch.uint8).to(torch.int16)).abs()
            assert int(d.max()) <= 1


# ------------------------------------------------- the exact path's kernels


@pytest.mark.parametrize("in_hw,out_hw", [((36, 64), (72, 128)),
                                          ((54, 96), (40, 72)),
                                          ((36, 64), (36, 64)),
                                          ((72, 128), (30, 50))],
                         ids=["2x", "3:4", "identity", "down"])
def test_oracle_scale_bitwise(cuda, in_hw, out_hw):
    rng = np.random.default_rng(0)
    # codes read as UNORM8, the ties' codes, and values past both clamps
    img = torch.from_numpy(rng.random((*in_hw, 4), dtype=np.float32)
                           * np.float32(1.4) - np.float32(0.2)).to(cuda)
    k = oracle_scale(img, *out_hw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.cpu().numpy(),
                                  oracle_scale_plain(img, *out_hw).cpu()
                                  .numpy())


@pytest.mark.parametrize("t", [0.25, 0.5])
@pytest.mark.parametrize("motion", [True, False], ids=["mv", "crossfade"])
def test_oracle_warp_bitwise(cuda, t, motion):
    rng = np.random.default_rng(1)
    h, w = 40, 72
    p, c = (torch.from_numpy(rng.random((h, w, 4), dtype=np.float32))
            .to(cuda) for _ in range(2))
    # MVs reaching past every edge, at sub-pixel offsets
    mv = (torch.from_numpy((rng.standard_normal((h, w, 2)) * 12)
                           .astype(np.float32)).to(cuda) if motion else None)
    k = oracle_warp(p, c, mv, t)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.cpu().numpy(),
                                  oracle_warp_plain(p, c, mv, t).cpu()
                                  .numpy())


def test_oracle_scale_unorm8_ties_and_clamps(cuda):
    """1x1 frames: one valid tap of weight 1, so each value reaches the
    UNORM8 store unchanged; every exact .5 tie rounds to the even code,
    as the plain version's torch.round does."""
    tie = np.arange(255, dtype=np.float32) + np.float32(0.5)
    tie_v = tie / np.float32(255)
    tie_v = tie_v[tie_v * np.float32(255) == tie]
    vals = np.concatenate([tie_v, np.float32([-0.1, 1.2, 0.0, 1.0])])
    vals = np.concatenate([vals, np.zeros(-len(vals) % 4, np.float32)])
    for v4 in vals.reshape(-1, 1, 1, 4):
        x = torch.from_numpy(v4).to(cuda)
        k = oracle_scale(x, 1, 1)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(k.cpu().numpy(),
                                      oracle_scale_plain(x, 1, 1).cpu()
                                      .numpy())
        codes = k.cpu().numpy().ravel()[np.isin(v4.ravel(), tie_v)]
        assert (codes % 2 == 0).all()


def test_oracle_kernels_refuse_what_they_do_not_take(cuda):
    img = torch.zeros((8, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="RGBA"):
        oracle_scale(img, 16, 16)
    f = torch.zeros((8, 8, 4), device=cuda)
    with pytest.raises(ValueError, match="per-pixel"):
        oracle_warp(f, f, torch.zeros((4, 4, 2), device=cuda), 0.5)


@pytest.mark.parametrize("k,mode", [(2, "pyramid"), (3, "none")])
def test_exact_step_kernel_path_matches_plain_path(cuda, k, mode):
    h, w = 48, 80
    cfg = EngineConfig(input_width=w, input_height=h, output_width=2 * w,
                       output_height=2 * h, block_size=4, search_radius=3,
                       fps_multiplier=k, motion_mode=mode)
    fr = [torch.from_numpy(f).to(cuda)
          for f in SyntheticSource(w, h, n_frames=2)]
    outs = [_in(scope, make_interp_step(cfg, "exact", device=cuda), *fr)
            for scope in PATHS]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    p, c = (oracle.dequantize_unorm8(f) for f in fr)
    np.testing.assert_array_equal(
        exact_mv(p, c, 4, 3).cpu().numpy(),
        (-oracle.motion_search(p, c, 4, 3)).cpu().numpy())
    scale = [_in(scope, make_exact_scale_step(cfg, cuda), fr[0])
             for scope in PATHS]
    np.testing.assert_array_equal(scale[0].cpu().numpy(),
                                  scale[1].cpu().numpy())


@pytest.mark.parametrize("c", [8, 16, 96, 240])
def test_bias_prelu_bitwise(cuda, c):
    from tpufg_torch.kernels.prelu import bias_prelu, bias_prelu_plain
    g = torch.Generator(device=cuda).manual_seed(c)
    y = torch.randn((1, c, 37, 53), generator=g, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn((c,), generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn((c,), generator=g, device=cuda).to(torch.bfloat16)
    want = bias_prelu_plain(y, b, a)
    torch_ = torch.nn.functional.prelu(y + b[None, :, None, None], a)
    before = bias_prelu.launches
    got = bias_prelu(y.clone(), b, a)
    assert bias_prelu.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(got, torch_)
    with pytest.raises(ValueError, match="multiple of 8"):
        bias_prelu(y[:, :c - 3].contiguous(memory_format=torch.channels_last),
                   b[:c - 3].contiguous(), a[:c - 3].contiguous())


def test_ifnet_warps_bitwise(cuda):
    from tpufg_torch.kernels.warp_grid import (warp_features_into,
                                               warp_frames, warp_plain)
    g = torch.Generator(device=cuda).manual_seed(3)
    frames = torch.rand((2, 4, 45, 77), generator=g, device=cuda)
    flow = (torch.rand((2, 2, 45, 77), generator=g, device=cuda) - 0.5) * 60
    for c in (3, 4):
        assert torch.equal(warp_frames(frames[:, :c], flow),
                           warp_plain(frames[:, :c], flow))
    cl = torch.channels_last
    for c in (16, 128):
        feats = torch.randn((1, c, 45, 77), generator=g, device=cuda).to(
            torch.bfloat16).contiguous(memory_format=cl)
        got = torch.zeros((1, c + 32, 45, 77), dtype=torch.bfloat16,
                          device=cuda).contiguous(memory_format=cl)
        want = got.clone()
        warp_features_into(got, 32, feats, flow[1:2])
        want[:, 32:].copy_(warp_plain(feats.float(), flow[1:2]))
        assert torch.equal(got, want)


def test_ifnet_pack_and_merge_bitwise(cuda):
    from tpufg_torch.kernels.merge import ifnet_merge, ifnet_merge_plain
    from tpufg_torch.kernels.pack import pack_nhwc, pack_nhwc_plain
    g = torch.Generator(device=cuda).manual_seed(5)
    frames = torch.rand((2, 4, 40, 72), generator=g, device=cuda) * 3 - 1
    pieces = [frames[:, :3], frames[0:1, 3:4], frames[1:2, :2]]
    for channels in (16, 24):
        got = pack_nhwc(pieces, channels)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, pack_nhwc_plain(pieces, channels))
    rgb = [frames[0:1, :3]]
    got = pack_nhwc(rgb, 16, s2d=True)
    assert got.shape == (1, 16, 21, 37)
    assert torch.equal(got, pack_nhwc_plain(rgb, 16, s2d=True))
    sig = torch.rand((1, 1, 40, 72), generator=g, device=cuda)
    u = (torch.randn((1, 16, 20, 36), generator=g, device=cuda) * 4).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for h, w in ((40, 72), (33, 61)):
        assert torch.equal(ifnet_merge(frames, sig, u, h, w),
                           ifnet_merge_plain(frames, sig, u, h, w))


def test_ifnet_accum_and_slices_bitwise(cuda):
    from tpufg_torch.kernels.accum import ifnet_accum, ifnet_accum_plain
    from tpufg_torch.kernels.prelu import bias_prelu, bias_prelu_plain
    g = torch.Generator(device=cuda).manual_seed(9)
    cl = torch.channels_last
    for scale, (th, tw) in ((8.0, (5, 9)), (4.0, (9, 15)), (2.0, (17, 31))):
        t = torch.randn((1, 8, th, tw), generator=g, device=cuda).to(
            torch.bfloat16).contiguous(memory_format=cl)
        state = torch.randn((1, 5, int(th * 2 * scale), int(tw * 2 * scale)),
                            generator=g, device=cuda)
        assert torch.equal(ifnet_accum(t, None, scale),
                           ifnet_accum_plain(t, None, scale))
        assert torch.equal(ifnet_accum(t, state.clone(), scale),
                           ifnet_accum_plain(t, state.clone(), scale))
    y = torch.randn((1, 32, 19, 23), generator=g, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=cl)
    b, a = (torch.randn((32,), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    bufs = [torch.zeros((1, 64, 19, 23), dtype=torch.bfloat16, device=cuda
                        ).contiguous(memory_format=cl) for _ in range(2)]
    bias_prelu(y, b, a, bufs[0][:, 32:], bufs[1][:, :32])
    want = bias_prelu_plain(y, b, a)
    assert torch.equal(bufs[0][:, 32:], want)
    assert torch.equal(bufs[1][:, :32], want)
    assert not bufs[0][:, :32].any() and not bufs[1][:, 32:].any()


def test_ifnet_step_matches_the_reference_at_1080p(cuda):
    import json
    import os
    from fgbench import check, load
    from fgbench.reference import rife_ifnet
    from fgbench.spec import ROOT
    from tpufg_torch.models import rife
    conf = json.load(open(os.path.join(ROOT, "fgbench", "configs",
                                       "c6-4k-rife-ifnet.json")))
    h, w = 1080, 1920
    e = dict(conf["engine"], input_width=w, input_height=h, output_width=w,
             output_height=h)
    cfg = EngineConfig(**e).validate()
    params = rife.load_params(os.path.join(ROOT, conf["checkpoint"]))
    bank = load.make_bank(2 ** 31 + 41, h, w, 3, 5, cuda)
    step = make_interp_step(cfg, wire="i32", device=cuda,
                            model_params=params)
    kept = {}
    for i in (1, 2):
        pair = [torch.from_numpy(bank[j].view(np.int32).reshape(h, w)).to(
            cuda) for j in (i - 1, i)]
        kept[i] = [o.cpu().numpy().view(np.uint8).reshape(h, w, 4)
                   for o in step(*pair)]
    limit = conf["limits"]["bad_byte_share"]
    with torch.no_grad():
        nums = {prec: check.compare(kept, "rgba", bank, rife_ifnet.make(
            dict(conf, engine=e), prec, cuda, ROOT), cuda)
            for prec in ("bf16", "fp8")}
    assert nums["bf16"]["missing_frames"] == 0
    assert nums["bf16"]["bad_byte_share"] <= limit
    assert nums["fp8"]["bad_byte_share"] > limit


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_ifnet_step_kernel_path_matches_plain_path(cuda, scale):
    """The IFNet step with its stream cache, bitwise between the kernel
    path and the plain path (540 rows: the pad to 64 and the crop)."""
    import os
    from fgbench import load
    from fgbench.spec import ROOT
    from tpufg_torch.models import rife
    h, w = 540, 960
    cfg = EngineConfig(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="learned",
                       learned_scale=scale)
    params = rife.load_params(os.path.join(ROOT, "checkpoints",
                                           "rife_ifnet_seed.json"))
    bank = load.make_bank(2 ** 31 + 43, h, w, 3, 5, cuda)
    wires = [torch.from_numpy(b.view(np.int32).reshape(h, w)).to(cuda)
             for b in bank]
    got = []
    step = make_interp_step(cfg, wire="i32", device=cuda,
                            model_params=params, q_feed=True)
    q_init = make_q_init(cfg, params, cuda)
    for scope in PATHS:
        with scope():
            q = q_init(wires[0])
            outs = []
            for i in (1, 2):
                *o, q = step(wires[i - 1], wires[i], q)
                outs += o
        got.append(outs + list(q))
    assert all(torch.equal(a, b) for a, b in zip(*got))


def _raft_pyramid(cuda, h8, w8, seed):
    from tpufg_torch.models import raft
    g = torch.Generator(device=cuda).manual_seed(seed)
    f1, f2 = (torch.randn((1, 256, h8, w8), generator=g, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for _ in range(2))
    return raft.corr_pyramid(f1, f2)


def test_corr_lookup_bitwise_at_1080p(cuda):
    """RAFT's lookup at 1080p's 1/8 grid (135 x 240, a 4.2 GB level 0):
    coordinates on the grid, moved by up to +-40 px (past every edge of
    every level) and by fractions, bitwise to the published four
    grid_samples."""
    from tpufg_torch.kernels.corr_lookup import (corr_lookup,
                                                 corr_lookup_plain)
    from tpufg_torch.models import raft
    h8, w8 = 135, 240
    pyramid = _raft_pyramid(cuda, h8, w8, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    base = raft.coords_grid(h8, w8, cuda)
    for scale in (0.0, 3.0, 40.0):
        coords = (base + scale * (torch.rand(base.shape, generator=g,
                                             device=cuda) * 2 - 1)
                  ).contiguous()
        before = corr_lookup.launches
        k = corr_lookup(pyramid, coords)
        torch.cuda.synchronize()
        assert corr_lookup.launches == before + 1
        want = corr_lookup_plain(pyramid, coords)
        assert k.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(k.view(torch.int16), want.view(torch.int16)), (
            scale, int((k != want).sum()))
        assert not k[:, 324:].any()


def test_corr_pool_bitwise(cuda):
    """The pyramid's three levels in one pass, bitwise to three
    avg_pool2d: at 1080p's 1/8 grid (135 x 240, an odd height; 16-byte
    loads) and at the odd widths of a 124 x 150 frame's (16 x 19) and of
    17 x 30 (scalar loads), with maps of negative, positive and zero
    values."""
    from tpufg_torch.kernels.corr_pool import corr_pool, corr_pool_plain
    g = torch.Generator(device=cuda).manual_seed(11)
    for h8, w8 in ((135, 240), (16, 19), (17, 30)):
        n = h8 * w8
        level0 = torch.randn((n, 1, h8, w8), generator=g, device=cuda) * 50
        level0[::7] = 0.0
        before = corr_pool.launches
        got = corr_pool(level0)
        torch.cuda.synchronize()
        assert corr_pool.launches == before + 1
        want = corr_pool_plain(level0)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert torch.equal(_bits(a), _bits(b)), (h8, w8, a.shape)
        del level0, got, want


def test_convex_upsample_bitwise_at_1080p(cuda):
    from tpufg_torch.kernels.convex_upsample import (convex_upsample,
                                                     convex_upsample_plain)
    g = torch.Generator(device=cuda).manual_seed(9)
    h8, w8 = 135, 240
    flow = torch.randn((1, 2, h8, w8), generator=g, device=cuda) * 4
    mask = (torch.randn((1, 576, h8, w8), generator=g, device=cuda) * 12
            ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    before = convex_upsample.launches
    k = convex_upsample(flow, mask)
    torch.cuda.synchronize()
    assert convex_upsample.launches == before + 1
    assert k.shape == (1, 2, 1080, 1920)
    assert torch.equal(_bits(k), _bits(convex_upsample_plain(flow, mask)))


def _raft_params():
    import os
    from fgbench.spec import ROOT
    from tpufg_torch.models import rife
    return rife.load_params(os.path.join(ROOT, "checkpoints",
                                         "raft_seed.json"))


def test_raft_gru_bitwise_at_1080p(cuda):
    """The GRU's two passes at 1080p's 1/8 grid, bitwise to their plain
    versions: r h into a slice of the 384-channel input; the update of h
    in place, into that slice and into the heads' copy."""
    from tpufg_torch.kernels.raft_gru import gru_gates, gru_update
    g = torch.Generator(device=cuda).manual_seed(10)
    cl = torch.channels_last

    def bf(c, scale=3.0):
        return (torch.randn((1, c, 135, 240), generator=g, device=cuda)
                * scale).to(torch.bfloat16).contiguous(memory_format=cl)

    zr, q = bf(256), bf(128)
    bias_zr = torch.randn(256, generator=g, device=cuda).to(torch.bfloat16)
    bias_q = torch.randn(128, generator=g, device=cuda).to(torch.bfloat16)
    h0 = torch.tanh(bf(128).float()).contiguous(memory_format=cl)
    buf0, copy0 = bf(384), bf(128)
    got = []
    for scope in PATHS:
        with scope():
            buf, copy, h = buf0.clone(), copy0.clone(), h0.clone()
            gru_gates(zr, bias_zr, h, buf[:, :128])
            rh = buf.clone()
            gru_update(zr, bias_zr, q, bias_q, h, buf[:, :128], copy)
            torch.cuda.synchronize()
            got.append([rh, buf, copy, h])
    for a, b in zip(*got):
        assert torch.equal(_bits(a), _bits(b))


def test_raft_step_kernel_path_matches_plain_path_at_1080p(cuda):
    """RAFT's 1080p -> 4K step with its stream cache over 3 pairs, bitwise
    between the kernel path (the flow as one CUDA graph replay, captured
    on the first pair) and the plain path (eager; outputs and cache), and
    the launches of pairs 2 and 3, a pair: 12 lookups, 1 pooling of the
    pyramid, 1 upsampling, 118 bias adds (32 in curr's encoders, 7 an
    update, 2 in the mask), 12 x 2 of each GRU pass, 1 warp of both frames
    a blend factor, 1 pack of curr."""
    from fgbench import load
    from tpufg_torch.kernels.convex_upsample import convex_upsample
    from tpufg_torch.kernels.corr_lookup import corr_lookup
    from tpufg_torch.kernels.corr_pool import corr_pool
    from tpufg_torch.kernels.pack import pack_nhwc
    from tpufg_torch.kernels.prelu import bias_prelu
    from tpufg_torch.kernels.raft_gru import gru_gates, gru_update
    from tpufg_torch.kernels.warp_grid import warp_frames
    h, w = 1080, 1920
    cfg = EngineConfig(input_width=w, input_height=h, output_width=2 * w,
                       output_height=2 * h, motion_mode="learned")
    params = _raft_params()
    bank = load.make_bank(2 ** 31 + 45, h, w, 4, 5, cuda)
    wires = [torch.from_numpy(b.view(np.int32).reshape(h, w)).to(cuda)
             for b in bank]
    q_init = make_q_init(cfg, params, cuda)
    wrappers = (corr_lookup, corr_pool, convex_upsample, bias_prelu,
                gru_gates, gru_update, warp_frames, pack_nhwc)
    got = []
    for scope in PATHS:
        with scope():
            step = make_interp_step(cfg, wire="i32", device=cuda,
                                    model_params=params, q_feed=True)
            q = q_init(wires[0])
            outs = []
            for i in (1, 2, 3):
                if i == 2:
                    before = [fn.launches for fn in wrappers]
                *o, q = step(wires[i - 1], wires[i], q)
                outs += [t.clone() for t in o]
            torch.cuda.synchronize()
            got.append((outs + list(q),
                        [fn.launches - b for fn, b in zip(wrappers,
                                                          before)]))
    assert got[0][1] == [24, 2, 2, 236, 48, 48, 2, 2]
    assert got[1][1] == [0] * 8
    assert all(torch.equal(a, b) for a, b in zip(got[0][0], got[1][0]))


def test_raft_step_matches_the_reference_at_1080p(cuda):
    import json
    import os
    from fgbench import check, load
    from fgbench.reference import raft_flow
    from fgbench.spec import ROOT
    conf = json.load(open(os.path.join(ROOT, "fgbench", "configs",
                                       "c7-1080p-4k-raft.json")))
    cfg = EngineConfig(**conf["engine"]).validate()
    e = conf["engine"]
    h, w = e["input_height"], e["input_width"]
    oh, ow = e["output_height"], e["output_width"]
    params = _raft_params()
    bank = load.make_bank(2 ** 31 + 47, h, w, 3, 5, cuda)
    step = make_interp_step(cfg, wire="i32", device=cuda,
                            model_params=params)
    kept = {}
    for i in (1, 2):
        pair = [torch.from_numpy(bank[j].view(np.int32).reshape(h, w)).to(
            cuda) for j in (i - 1, i)]
        kept[i] = [o.cpu().numpy().view(np.uint8).reshape(oh, ow, 4)
                   for o in step(*pair)]
    limit = conf["limits"]["bad_byte_share"]
    with torch.no_grad():
        nums = {prec: check.compare(kept, "rgba", bank, raft_flow.make(
            conf, prec, cuda, ROOT), cuda) for prec in ("bf16", "fp8")}
    print("raft 1080p -> 4K against the reference:", nums)
    assert nums["bf16"]["missing_frames"] == 0
    assert nums["bf16"]["bad_byte_share"] <= limit
    assert nums["fp8"]["bad_byte_share"] > limit


class _Keeping(FrameSink):
    """Keeps output j where ``keep(j)`` holds, as handed over."""

    def __init__(self, keep=lambda j: True, wire_format="rgba"):
        self.keep, self.wire_format = keep, wire_format
        self.frames, self.n = [], 0

    def write(self, frame):
        if self.keep(self.n):
            self.frames.append(frame)
        self.n += 1


def _engine_reading_today(cuda, cfg, sink, precision="fast"):
    """An engine on the card whose steps also note each output's bytes as
    ``arr.cpu().numpy()`` reads them, in the steps' order."""
    engine = StreamingEngine(cfg, precision, device=cuda)
    engine._build_steps(engine._sink_wire(sink), False)
    today = []

    def noting(step):
        def run(*args):
            outs = step(*args)
            for o in (outs if isinstance(outs, (list, tuple)) else [outs]):
                today.append(o.cpu().numpy().tobytes())
            return outs
        return run

    engine._step1 = noting(engine._step1)
    engine._step2 = noting(engine._step2)
    engine._build_steps = lambda *args: None
    return engine, today


_READBACK_CFG = dict(input_width=128, input_height=64, output_width=256,
                     output_height=128)


@pytest.mark.parametrize("route", ["rgba", "y4m420", "exact"])
def test_engine_reads_each_output_back_into_a_block_of_its_own(cuda, route):
    sink = _Keeping(wire_format="y4m420" if route == "y4m420" else "rgba")
    engine, today = _engine_reading_today(
        cuda, EngineConfig(**_READBACK_CFG), sink,
        "exact" if route == "exact" else "fast")
    stats = engine.run(SyntheticSource(128, 64, n_frames=110), sink,
                       paced=False)
    n = 2 * 110 - 1
    assert stats.frames_out == stats.readback_pinned == n
    assert len(sink.frames) == len(today) == n
    shape = (192, 256) if route == "y4m420" else (128, 256, 4)
    for got, want in zip(sink.frames, today):
        assert got.dtype == np.uint8 and got.shape == shape
        assert got.tobytes() == want
    spans = sorted((f.__array_interface__["data"][0], f.nbytes)
                   for f in sink.frames)
    assert all(a + na <= b for (a, na), (b, _) in zip(spans, spans[1:]))


def test_engine_makes_pinned_blocks_only_in_the_top_up(cuda):
    """A warm-up run, then a run whose sink keeps 1 frame in 10: no block
    made inside a hand-over, one made in the top-up for each block kept.
    Outputs of 360 x 640 (a 1 MiB block, a size no other test here reads
    back into, so the cache holds none of it from before)."""
    cfg = EngineConfig(input_width=320, input_height=180, output_width=640,
                       output_height=360)
    engine = StreamingEngine(cfg, device=cuda)
    engine.run(SyntheticSource(320, 180, n_frames=10),
               _Keeping(lambda j: False), paced=False)
    sink = _Keeping(lambda j: j == 0 or (j - 1) // 2 % 10 == 9)
    stats = engine.run(SyntheticSource(320, 180, n_frames=41), sink,
                       paced=False)
    assert stats.readback_pinned == stats.frames_out == 81
    assert len(sink.frames) == 1 + 2 * 4
    assert stats.readback_host_allocs == 0
    assert stats.refill_host_allocs == len(sink.frames)


def test_engine_through_the_threaded_sink_writes_todays_bytes(cuda,
                                                              tmp_path):
    path = tmp_path / "out.raw"
    sink = AsyncSink(RawVideoSink(str(path)))
    engine, today = _engine_reading_today(
        cuda, EngineConfig(**_READBACK_CFG), sink)
    with sink:
        stats = engine.run(SyntheticSource(128, 64, n_frames=30), sink,
                           paced=False)
    assert stats.readback_pinned == len(today) == 59
    assert path.read_bytes() == b"".join(today)


class _KeepingDevice(FrameSink):
    """A device sink (``NullSink``'s wire) that keeps every output as it
    is handed over."""

    needs_host = False

    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame)


def _cut_frames(w, h):
    """Ten frames, pan, noise, pan: the pairs into, inside and out of the
    two noise frames are scene cuts at 0.1, the six others are not."""
    pan = list(SyntheticSource(w, h, n_frames=8))
    noise = list(SyntheticSource(w, h, n_frames=2, pattern="noise", seed=1))
    return pan[:4] + noise + pan[4:]


GRAPHED = {"config 4": {}, "config 4q": {"occlusion_blend": True},
           "config 3": {"identity": True, "motion_mode": "exhaustive"},
           "none": {"motion_mode": "none"}, "x3": {"fps_multiplier": 3},
           "cut": {"scene_cut_threshold": 0.1},
           "config 3 cut": {"identity": True, "motion_mode": "exhaustive",
                            "scene_cut_threshold": 0.1}}


@pytest.mark.parametrize("name", list(GRAPHED))
def test_engine_graphed_step_bitwise_to_the_eager_step(cuda, name):
    """Full size, 9 pairs: the engine's step, replayed from its CUDA graph,
    bitwise to ``make_interp_step`` run eagerly on the same frames (the
    first pair's prev also through the scale-only step), for configs 4,
    4q and 3, mode none, x3, and ``--scene-cut`` on pairs that cross
    cuts; the outputs a device sink kept are unchanged after the later
    pairs; one capture, every pair replayed; the kernels' launch counts
    those of the eager run and one pair more (the warm-up)."""
    from tpufg_torch.config import apply_quality_preset
    from tpufg_torch.engine.graph import GraphedStep
    from tpufg_torch.engine.pipeline import scene_cut
    from tpufg_torch.kernels.common import counted_wrappers
    h, w, n = 1080, 1920, 10
    opts = dict(GRAPHED[name])
    scale = 1 if opts.pop("identity", False) else 2
    cfg = EngineConfig(input_width=w, input_height=h,
                       output_width=scale * w, output_height=scale * h,
                       **opts)
    if name == "config 4q":
        cfg = apply_quality_preset(cfg).validate()
    cut = cfg.scene_cut_threshold > 0
    frames = (_cut_frames(w, h) if cut
              else list(SyntheticSource(w, h, n_frames=n)))
    wires = [torch.from_numpy(f.view(np.int32).reshape(h, w)).to(cuda)
             for f in frames]
    if cut:
        planes = [frames_to_planar(x) for x in wires]
        assert [bool(scene_cut(p, c, 0.1)) for p, c in
                zip(planes, planes[1:])] == [False] * 3 + [True] * 3 + [
                    False] * 3
    wrappers = counted_wrappers()

    def launches(run):
        for fn in wrappers:
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {fn.__name__: fn.launches for fn in wrappers}

    sink = _KeepingDevice()
    engine = StreamingEngine(cfg, device=cuda)
    stats, graphed = launches(lambda: engine.run(frames, sink, paced=False))
    assert isinstance(engine._graph, GraphedStep)
    assert (stats.graph_captures, stats.graph_replays) == (1, n - 1)
    # a list of frames declares no constant alpha: motion reads all four
    step = make_interp_step(cfg, wire="i32", device=cuda)

    def eager():
        want = [engine._step1(wires[0])]
        for prev, curr in zip(wires, wires[1:]):
            want += [o.clone() for o in step(prev, curr)]
        return want

    want, counts = launches(eager)
    _, one_pair = launches(lambda: step(*wires[:2]))
    assert graphed == {k: v + one_pair[k] for k, v in counts.items()}
    assert sum(one_pair.values()) > 0
    k = cfg.fps_multiplier
    assert len(sink.frames) == len(want) == stats.frames_out == k * (n - 1) + 1
    for got, ref in zip(sink.frames, want):
        assert torch.equal(got, ref)
