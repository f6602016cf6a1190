"""RIFE's own network (Huang et al., "Real-Time Intermediate Flow
Estimation for Video Frame Interpolation", ECCV 2022, arXiv:2011.06294;
github.com/hzwer/ECCV2022-RIFE, ``model/IFNet.py``, ``model/refine.py``,
``model/warplayer.py``, ``inference_video.py``), inference only, on the
card: the IFNet's three-block flow cascade, the Contextnet and the U-Net.

``conv(a, b, s)`` below is a 3x3 conv (stride s, pad 1, bias) followed by
PReLU(b); ``interp`` is bilinear resizing with ``align_corners=False``.

- **IFBlock(in, c)** at scale S: ``x = interp(x, 1/S)``; where a flow is
  given, ``x = cat(x, interp(flow, 1/S) / S)``; ``x = conv(c/2, c, 2)(
  conv(in, c/2, 2)(x))``; ``x = convblock(x) + x`` (8 x ``conv(c, c, 1)``);
  ``t = ConvTranspose2d(c, 5, 4, 2, 1)(x)`` resized by 2S; the flow is
  ``t[:4] * 2S``, the mask logit ``t[4:5]``.
- **IFNet** (scales ``4/s, 2/s, 1/s`` for RIFE's scale s; 8/4/2 at s =
  0.5, the UHD setting): ``block0 = IFBlock(6, 240)`` on ``cat(I0, I1)``,
  then ``block1 = IFBlock(17, 150)`` and ``block2 = IFBlock(17, 90)`` on
  ``cat(I0, I1, W0, W1, mask)`` and the flow, each adding its flow and
  mask; after each block ``W0 = warp(I0, flow[0:2])``, ``W1 = warp(I1,
  flow[2:4])`` at full size.  ``warp`` is ``grid_sample`` (bilinear,
  border, ``align_corners=True``) with the flow normalised by ``(W-1)/2``
  and ``(H-1)/2``.  The teacher block is training-only and not built.
- **Contextnet** (c = 16), per frame: four ``Conv2`` levels (``conv(a,
  b, 2)`` then ``conv(b, b, 1)``: 3->16, 16->32, 32->64, 64->128); level
  k's output is warped by its frame's flow halved in size and value k
  times.  The convs do not read the flow, so a frame's four conv outputs
  are its stream cache (:func:`context`); the 8 warps run per pair.
- **U-Net**: ``s0 = Conv2(17, 32)(cat(I0, I1, W0, W1, mask, flow))`` (the
  mask as a logit), ``s1..s3 = Conv2`` over the previous level and both
  frames' context at that level (64, 128, 256), four ``ConvTranspose2d(.,
  ., 4, 2, 1)`` + PReLU up with skips (512->128, 256->64, 128->32,
  64->16), a plain conv 16->3 and a sigmoid ``u``.
- **Output**: ``res = 2u - 1``; ``out = clamp(W0 sigmoid(mask) + W1 (1 -
  sigmoid(mask)) + res, 0, 1)``.

Frames: RGB in [0, 1], zero-padded right and bottom to a multiple of
``max(32, 32/s)`` as ``inference_video.py`` pads them, cropped back.  The
engine's frames are RGBA; the alpha channel is warped by the final flows
and merged by the final mask, with no residual, and padded with its last
row and column rather than zeros, so that a constant alpha stays constant
(255 after the store) where a flow reaches into the pad.

Precision (departures from the published f32 model): weights and every
conv, transposed conv and PReLU run in bf16 on cuDNN (f32 accumulation,
channels-last); a conv's bias is added to its bf16 output and rounded to
bf16, as PyTorch adds it, and before a PReLU that add and the PReLU run as
one pass (``kernels/prelu.py``, ``csrc/bias_prelu.cu``).  In f32: the flow and mask accumulation, the flow and
mask resizes, the frames' resizes (rounded to bf16 as a conv's input),
the sampling grids, the warps of the frames, the final sigmoid, merge and
clamp.  The Contextnet's bf16 features are warped in f32 (a bf16 grid
would place samples several pixels off) and stored in bf16.

The six passes outside cuDNN and ATen (the bias and PReLU, the packing of
a conv's input, both warps, the flow and mask accumulation and the merge)
are hand kernels, each bitwise to its plain torch version, which runs as
``kernels.common.plain_versions`` says.

Weights (:func:`load`): the published state-dict layout (``block0.conv0.
0.0.weight``, ..., ``contextnet.*``, ``unet.*``; a ``module.`` prefix is
stripped and the teacher's ``block_tea.*`` dropped) from a ``.pkl`` /
``.pth`` / ``.pt`` file (``torch.load(weights_only=True)``) or an
``.npz`` of the same keys, or a seeded recipe (``.json``,
``checkpoints/rife_ifnet_seed.json``) from which :func:`draw` makes them
with NumPy.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.accum import ifnet_accum
from tpufg_torch.kernels.merge import ifnet_merge
from tpufg_torch.kernels.pack import pack_nhwc
from tpufg_torch.kernels.prelu import bias_prelu
from tpufg_torch.kernels.warp_grid import warp_features_into, warp_frames

F32 = torch.float32
BF16 = torch.bfloat16
CL = torch.channels_last

ARCH = "rife_ifnet"
# (name, input channels, width) of the three IFBlocks
BLOCKS = (("block0", 6, 240), ("block1", 17, 150), ("block2", 17, 90))
CONVBLOCK = 8
CONTEXT = 16
# the layers the recipe draws with a gain instead of He-normal
GAINED = ("block0.lastconv", "block1.lastconv", "block2.lastconv",
          "unet.conv")
_TEACHER = "block_tea."


# ------------------------------------------------------------------ weights

class IFNetParams(dict):
    """The IFNet's weights: {published state-dict key: array or tensor},
    tagged by its type so the learned path can tell it from a v3 head."""


def _conv_keys(prefix: str, cin: int, cout: int, act: bool = True) -> dict:
    out = {f"{prefix}.0.weight": (cout, cin, 3, 3), f"{prefix}.0.bias": (cout,)}
    if act:
        out[f"{prefix}.1.weight"] = (cout,)
    return out


def _conv2_keys(prefix: str, cin: int, cout: int) -> dict:
    return {**_conv_keys(f"{prefix}.conv1", cin, cout),
            **_conv_keys(f"{prefix}.conv2", cout, cout)}


@functools.lru_cache(maxsize=1)
def layer_shapes() -> dict:
    """{key: shape} of the published state dict (the teacher left out),
    in the modules' order."""
    out: dict = {}
    for name, cin, c in BLOCKS:
        out.update(_conv_keys(f"{name}.conv0.0", cin, c // 2))
        out.update(_conv_keys(f"{name}.conv0.1", c // 2, c))
        for i in range(CONVBLOCK):
            out.update(_conv_keys(f"{name}.convblock.{i}", c, c))
        out[f"{name}.lastconv.weight"] = (c, 5, 4, 4)
        out[f"{name}.lastconv.bias"] = (5,)
    chans = (3, CONTEXT, 2 * CONTEXT, 4 * CONTEXT, 8 * CONTEXT)
    for k in range(4):
        out.update(_conv2_keys(f"contextnet.conv{k + 1}", chans[k],
                               chans[k + 1]))
    c = CONTEXT
    for k, (cin, cout) in enumerate(((17, 2 * c), (4 * c, 4 * c),
                                     (8 * c, 8 * c), (16 * c, 16 * c))):
        out.update(_conv2_keys(f"unet.down{k}", cin, cout))
    for k, (cin, cout) in enumerate(((32 * c, 8 * c), (16 * c, 4 * c),
                                     (8 * c, 2 * c), (4 * c, c))):
        out[f"unet.up{k}.0.weight"] = (cin, cout, 4, 4)
        out[f"unet.up{k}.0.bias"] = (cout,)
        out[f"unet.up{k}.1.weight"] = (cout,)
    out["unet.conv.weight"] = (3, c, 3, 3)
    out["unet.conv.bias"] = (3,)
    return out


def _transposed(key: str) -> bool:
    return key.endswith(".lastconv.weight") or (
        key.startswith("unet.up") and key.endswith(".0.weight"))


def _fan_in(key: str, shape) -> int:
    """Inputs that reach one output: a 3x3 conv's ``in * 9``; a stride-2
    4x4 transposed conv's ``in * 4`` (each output pixel meets 2 x 2 of its
    taps)."""
    return shape[0] * 4 if _transposed(key) else shape[1] * 9


def draw(recipe: dict) -> IFNetParams:
    """The weights a seeded recipe names, drawn with NumPy's PCG64 from
    ``recipe["seed"]``: in :func:`layer_shapes` order, each conv and
    transposed-conv weight ``standard_normal(shape, float32) * std``
    (He-normal for PReLU(a), ``std = sqrt(2 / ((1 + a^2) fan_in))``, or
    ``gain / sqrt(fan_in)`` for the :data:`GAINED` layers), biases 0,
    PReLU slopes ``a``."""
    init = recipe["init"]
    a = float(init["prelu"])
    gains = init["gains"]
    rng = np.random.default_rng(int(recipe["seed"]))
    out = IFNetParams()
    for key, shape in layer_shapes().items():
        if key.endswith(".bias"):
            out[key] = np.full(shape, float(init["bias"]), np.float32)
        elif len(shape) == 1:
            out[key] = np.full(shape, a, np.float32)
        else:
            layer = key[:-len(".weight")]
            fan = _fan_in(key, shape)
            std = (float(gains[layer]) / np.sqrt(fan) if layer in gains
                   else np.sqrt(2.0 / ((1.0 + a * a) * fan)))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
    return out


def _check_recipe(recipe: dict, path: str) -> None:
    if recipe.get("architecture") != ARCH:
        raise ValueError(f"{path}: architecture "
                         f"{recipe.get('architecture')!r}, expected {ARCH!r}")
    init = recipe.get("init", {})
    for field in ("prelu", "bias", "gains"):
        if field not in init:
            raise ValueError(f"{path}: init.{field} missing")
    if not isinstance(recipe.get("seed"), int):
        raise ValueError(f"{path}: seed must be an integer")
    if sorted(init["gains"]) != sorted(GAINED):
        raise ValueError(f"{path}: init.gains {sorted(init['gains'])}, "
                         f"expected {sorted(GAINED)}")


def _read_state(path: str) -> dict:
    """{key: float32 array} of a state-dict file, as stored."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict")
    out = {}
    for k, v in sd.items():
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"{path}: {k} is not a tensor")
        if v.dtype != F32:
            raise ValueError(f"{path}: {k} is {v.dtype}, expected float32")
        out[k] = v.numpy()
    return out


def from_state_dict(state: dict, where: str = "state dict") -> IFNetParams:
    """The published layout held to :func:`layer_shapes`: a ``module.``
    prefix stripped, the teacher's keys dropped; a missing or unknown
    key, or a wrong shape or dtype, raises ValueError naming it."""
    shapes = layer_shapes()
    out = IFNetParams()
    for key, arr in state.items():
        k = key[len("module."):] if key.startswith("module.") else key
        if k.startswith(_TEACHER):
            continue
        if k not in shapes:
            raise ValueError(f"{where}: unknown key {key!r}")
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            raise ValueError(f"{where}: {key} is {arr.dtype}, expected "
                             "float32")
        if tuple(arr.shape) != shapes[k]:
            raise ValueError(f"{where}: {key} has shape {tuple(arr.shape)}, "
                             f"expected {shapes[k]}")
        out[k] = arr
    missing = [k for k in shapes if k not in out]
    if missing:
        raise ValueError(f"{where}: missing {missing[0]!r}"
                         + (f" and {len(missing) - 1} more"
                            if len(missing) > 1 else ""))
    return IFNetParams((k, out[k]) for k in shapes)


def load(path: str) -> IFNetParams:
    """The weights of a recipe (``.json``), an ``.npz`` of the published
    keys, or a published ``.pkl`` / ``.pth`` / ``.pt`` state dict."""
    if path.endswith(".json"):
        with open(path) as f:
            recipe = json.load(f)
        _check_recipe(recipe, path)
        return draw(recipe)
    return from_state_dict(_read_state(path), path)


def looks_like(path: str) -> bool:
    """Whether ``path`` holds IFNet weights rather than a v3-family
    parameter tree (a recipe, a torch state dict, or an ``.npz`` without
    ``__treedef__``)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return "__treedef__" not in data.files
    return os.path.splitext(path)[1] in (".json", ".pkl", ".pth", ".pt")


def n_params(params: dict) -> int:
    return sum(int(np.prod(v.shape)) for v in params.values())


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _padded(t: torch.Tensor) -> torch.Tensor:
    """Every channel count (a weight's dims 0 and 1, a bias's or slope's
    length) zero-padded to a multiple of 8.  cuDNN's channels-last bf16
    convs pad such tensors in a pass of their own at every call (the
    blocks' 75, 150, 45 and 90, the 17- and 3-channel inputs, the 5 and 3
    outputs); a zero channel stays zero through the bias (0), the PReLU and
    the residual, so the program slices the outputs it reads and builds
    its inputs with the zero channels."""
    if t.ndim == 4:
        return F.pad(t, (0, 0, 0, 0, 0, _pad8(t.shape[1]) - t.shape[1],
                         0, _pad8(t.shape[0]) - t.shape[0]))
    return F.pad(t, (0, _pad8(t.shape[0]) - t.shape[0]))


_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))   # (row, column) parity
# a stride-2 3x3 conv's tap k (pad 1) on s2d row offset a (0: the pair
# above) and parity p: (a, p) -> k
_S2D_IN_TAP = {(0, 1): 0, (1, 0): 1, (1, 1): 2}
# a stride-2 4x4 transposed conv's (pad 1) tap k for output parity p from
# input offset d: (p, d) -> k
_S2D_OUT_TAP = {(0, 0): 1, (0, -1): 3, (1, 1): 0, (1, 0): 2}


def _s2d_input(w: torch.Tensor, channels: int) -> torch.Tensor:
    """A stride-2 3x3 conv's weight [co, ci, 3, 3] as a 2x2 conv's on its
    input space-to-depth by 2 behind a zero row and column
    (``pack_nhwc(s2d=True)``, channel ``phase * ci + c``), ``channels``
    inputs."""
    co, ci = w.shape[:2]
    out = w.new_zeros((co, channels, 2, 2))
    for ph, (py, px) in enumerate(_PHASES):
        for a in (0, 1):
            for b in (0, 1):
                ky, kx = _S2D_IN_TAP.get((a, py)), _S2D_IN_TAP.get((b, px))
                if ky is not None and kx is not None:
                    out[:, ph * ci:(ph + 1) * ci, a, b] = w[:, :, ky, kx]
    return out


def _s2d_tconv(wt: torch.Tensor) -> torch.Tensor:
    """A stride-2 4x4 transposed conv's weight [ci, co, 4, 4] as a 3x3
    conv's (pad 1) whose output is the transposed conv's space-to-depth by
    2 (channel ``phase * co + c``)."""
    ci, co = wt.shape[:2]
    out = wt.new_zeros((4 * co, ci, 3, 3))
    for ph, (py, px) in enumerate(_PHASES):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ky, kx = _S2D_OUT_TAP.get((py, dy)), _S2D_OUT_TAP.get((px, dx))
                if ky is not None and kx is not None:
                    out[ph * co:(ph + 1) * co, :, dy + 1, dx + 1] = (
                        wt[:, :, ky, kx].t())
    return out


def _s2d_conv(w: torch.Tensor, channels: int) -> torch.Tensor:
    """A 3x3 conv's weight [o, c, 3, 3] (pad 1) as a 3x3 conv's (pad 1)
    from its input space-to-depth by 2 to its output space-to-depth by 2
    (channel ``phase * o + k``), ``channels`` outputs."""
    o, c = w.shape[:2]
    out = w.new_zeros((channels, 4 * c, 3, 3))
    for ph, (py, px) in enumerate(_PHASES):
        for qh, (qy, qx) in enumerate(_PHASES):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ky, kx = 2 * dy + qy - py + 1, 2 * dx + qx - px + 1
                    if 0 <= ky <= 2 and 0 <= kx <= 2:
                        out[ph * o:(ph + 1) * o, qh * c:(qh + 1) * c,
                            dy + 1, dx + 1] = w[:, :, ky, kx]
    return out


def _s2d_weights(params: dict) -> dict:
    """The weights of the three full-size layers rewritten on
    space-to-depth tensors (keys ending ``@s2d``; f32): the Contextnet's
    first conv (stride 2, 3 inputs), the U-Net's last transposed conv with
    its bias and slope per phase, and the U-Net's last conv with its bias.
    cuDNN runs a conv with 8 or 16 channels at full size far from its
    bound (1.3 ms and 1.0 ms a 4K frame on an H100, 0.8 ms for the
    transposed conv); these run at half size on 16 and 64 channels.  The
    sums are the same but for zero terms."""
    def f32(k):
        v = params[k]
        return torch.as_tensor(np.asarray(v, np.float32) if not isinstance(
            v, torch.Tensor) else v, dtype=F32)

    def tile4(v, n=None):
        t = f32(v).repeat(4)
        return F.pad(t, (0, (n or t.numel()) - t.numel()))

    return {
        "contextnet.conv1.conv1.0.weight@s2d": _s2d_input(
            f32("contextnet.conv1.conv1.0.weight"), 16),
        "unet.up3.0.weight@s2d": _s2d_tconv(f32("unet.up3.0.weight")),
        "unet.up3.0.bias@s2d": tile4("unet.up3.0.bias"),
        "unet.up3.1.weight@s2d": tile4("unet.up3.1.weight"),
        "unet.conv.weight@s2d": _s2d_conv(f32("unet.conv.weight"), 16),
        "unet.conv.bias@s2d": tile4("unet.conv.bias", 16),
    }


def to_device(params: IFNetParams, device: torch.device) -> IFNetParams:
    """The program's copy: bf16 tensors on ``device``, 4-D weights
    channels-last, every channel count padded to a multiple of 8
    (:func:`_padded`), with the space-to-depth rewrites of
    :func:`_s2d_weights`; params already so are returned as they are."""
    first = next(iter(params.values()))
    if (isinstance(first, torch.Tensor) and first.dtype == BF16
            and first.device == device):
        return params
    out = IFNetParams()
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v, np.float32) if not isinstance(
            v, torch.Tensor) else v, dtype=F32, device=device)
        t = _padded(t).to(BF16)
        out[k] = t.contiguous(memory_format=CL) if t.ndim == 4 else t
    for k, t in _s2d_weights(params).items():
        t = t.to(device=device, dtype=BF16)
        out[k] = t.contiguous(memory_format=CL) if t.ndim == 4 else t
    return out


# -------------------------------------------------------------------- model

def pad_multiple(scale: float) -> int:
    """``inference_video.py``'s pad: ``max(32, 32 / scale)``."""
    return max(32, int(32 / scale))


def block_scales(scale: float) -> tuple[float, float, float]:
    return (4.0 / scale, 2.0 / scale, 1.0 / scale)


def _resize(x: torch.Tensor, factor: float) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=False)


def _conv(p: dict, key: str, x: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """3x3 conv + PReLU: the bias-free cuDNN conv, then the bias and PReLU
    in one pass (``kernels/prelu.py``)."""
    y = F.conv2d(x, p[key + ".0.weight"], None, stride, 1)
    return bias_prelu(y, p[key + ".0.bias"], p[key + ".1.weight"])


def _conv2(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    return _conv(p, key + ".conv2", _conv(p, key + ".conv1", x, 2))


def _pair_flows(flow: torch.Tensor) -> torch.Tensor:
    """[1, 4, h, w] (frame 0's flow, then frame 1's) -> [2, 2, h, w]."""
    return flow.reshape(2, 2, *flow.shape[2:])


def _ifblock(p: dict, name: str, frames: torch.Tensor, warped, mask,
             flow, scale: float):
    """One IFBlock -> its last transposed conv's output t, bf16
    channels-last [1, 8, H / 2S, W / 2S] (channels 0-3 the flow delta over
    ``2S``, 4 the mask delta, 5-7 zero).  ``frames``: both padded frames
    [2, >= 3, H, W] (RGB read); ``warped`` [2, 3, H, W], ``mask`` and
    ``flow`` (None for the first block).  ``interp(cat(x))`` is ``cat(interp(x_i))`` (bilinear
    resizing runs a channel at a time), so each part is resized alone and
    the block's input packed at its size."""
    def small(x):
        return x if scale == 1 else _resize(x, 1.0 / scale)

    x = small(frames[:, :3])
    pieces = [x.reshape(1, 6, *x.shape[2:])]
    if flow is not None:
        pieces += [small(warped).reshape(1, 6, *x.shape[2:]), small(mask),
                   _resize(flow, 1.0 / scale) / scale]
    x = pack_nhwc(pieces, p[f"{name}.conv0.0.0.weight"].shape[1])
    x = _conv(p, f"{name}.conv0.0", x, 2)
    x = _conv(p, f"{name}.conv0.1", x, 2)
    y = x
    for i in range(CONVBLOCK):
        y = _conv(p, f"{name}.convblock.{i}", y)
    x = y + x
    return F.conv_transpose2d(x, p[f"{name}.lastconv.weight"],
                              p[f"{name}.lastconv.bias"], 2, 1)


def flows(p: dict, frames: torch.Tensor, scale: float):
    """The IFNet on both padded f32 RGBA frames [2, 4, H, W] -> (flow [1,
    4], mask logit [1, 1], both frames warped by it [2, 4, H, W], alpha
    too), all f32 at full size."""
    # the flow and the mask logit as one f32 [1, 5]: each block's output
    # resized by 2S and added, its flow times 2S, in one pass
    # (kernels/accum.py)
    state = flow = mask = warped = None
    for i, ((name, _, _), s) in enumerate(zip(BLOCKS, block_scales(scale))):
        state = ifnet_accum(_ifblock(p, name, frames, warped, mask, flow, s),
                            state, s)
        flow, mask = state[:, :4], state[:, 4:5]
        last = i == len(BLOCKS) - 1
        warped = warp_frames(frames if last else frames[:, :3],
                             _pair_flows(flow))
    return flow, mask, warped


def context(p: dict, img: torch.Tensor) -> tuple:
    """A padded f32 RGBA frame [1, 4, H, W]'s Contextnet conv outputs, the
    stream cache: bf16 [1, 16 << k, H >> (k + 1), W >> (k + 1)], k < 4."""
    # level 1's stride-2 conv as a 2x2 conv on the frame space-to-depth
    x = F.conv2d(pack_nhwc([img[:, :3]], 16, s2d=True),
                 p["contextnet.conv1.conv1.0.weight@s2d"])
    x = bias_prelu(x, p["contextnet.conv1.conv1.0.bias"],
                   p["contextnet.conv1.conv1.1.weight"])
    x = _conv(p, "contextnet.conv1.conv2", x)
    out = [x]
    for level in range(1, 4):
        x = _conv2(p, f"contextnet.conv{level + 1}", x)
        out.append(x)
    return tuple(out)


def _buffer(like: torch.Tensor, channels: int) -> torch.Tensor:
    """An uninitialised channels-last bf16 [1, channels, h, w] at
    ``like``'s size, a concatenation that its parts are written into."""
    return torch.empty((1, channels, *like.shape[2:]), dtype=BF16,
                       device=like.device, memory_format=CL)


def _conv2_into(p: dict, key: str, x: torch.Tensor, width: int,
                into) -> list:
    """A ``Conv2`` whose output (``width`` channels) is written at once
    into new concatenations of the U-Net, one a (channels, channel offset)
    of ``into``; returns them."""
    y = _conv(p, key + ".conv1", x, 2)
    z = F.conv2d(y, p[key + ".conv2.0.weight"], None, 1, 1)
    bufs = [_buffer(z, channels) for channels, _ in into]
    bias_prelu(z, p[key + ".conv2.0.bias"], p[key + ".conv2.1.weight"],
               *(b[:, off:off + width] for b, (_, off) in zip(bufs, into)))
    return bufs


def refine(p: dict, frames: torch.Tensor, flow: torch.Tensor,
           mask: torch.Tensor, sig: torch.Tensor, warped: torch.Tensor,
           ctx0: tuple, ctx1: tuple, crop: tuple[int, int]) -> torch.Tensor:
    """The 8 context warps, the U-Net, the merge, the clamp and the crop
    to ``crop`` = (h, w) -> f32 [4, h, w] in [0, 1]; ``sig`` is
    sigmoid(mask).

    Each concatenation of the U-Net is one channels-last buffer that its
    parts are written into where they are made: a level's ``Conv2`` output
    (through its bias and PReLU, into the next level's input and into the
    skip of the way up), both frames' warped context beside it, each
    transposed conv's output ahead of its skip."""
    c = CONTEXT
    x = pack_nhwc([frames[0:1, :3], frames[1:2, :3], warped[0:1, :3],
                   warped[1:2, :3], mask, flow],
                  p["unet.down0.conv1.0.weight"].shape[1])
    # level k's input (k = 1..4: s_{k-1}, then both frames' context) and
    # the way up's inputs (up k's output, then the skip s_{3-k})
    widths = (2 * c, 4 * c, 8 * c, 16 * c)
    ups: list = [None, None, None]          # inputs of up1, up2, up3
    f = flow
    for lv in range(4):
        into = [(widths[lv] + 2 * ctx0[lv].shape[1], 0)]
        if lv < 3:
            into.append((2 * widths[lv], widths[lv]))
        x, *skip = _conv2_into(p, f"unet.down{lv}", x, widths[lv], into)
        if skip:
            ups[2 - lv] = skip[0]
        f = _resize(f, 0.5) * 0.5
        warp_features_into(x, widths[lv], ctx0[lv], f[:, 0:2])
        warp_features_into(x, widths[lv] + ctx0[lv].shape[1], ctx1[lv],
                           f[:, 2:4])
    for lv in range(3):
        y = F.conv_transpose2d(x, p[f"unet.up{lv}.0.weight"], None, 2, 1)
        bias_prelu(y, p[f"unet.up{lv}.0.bias"], p[f"unet.up{lv}.1.weight"],
                   ups[lv][:, :y.shape[1]])
        x = ups[lv]
    # the full-size tail on space-to-depth tensors at half size: up3 as a
    # 3x3 conv giving its output's four phases, the last conv from and to
    # them
    x = F.conv2d(x, p["unet.up3.0.weight@s2d"], None, 1, 1)
    x = bias_prelu(x, p["unet.up3.0.bias@s2d"], p["unet.up3.1.weight@s2d"])
    u = F.conv2d(x, p["unet.conv.weight@s2d"], p["unet.conv.bias@s2d"], 1, 1)
    return ifnet_merge(warped, sig, u, *crop)


def pad_frames(prev: torch.Tensor, curr: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Planar f32 [4, h, w] prev and curr -> [2, 4, H, W], padded right and
    bottom to :func:`pad_multiple`: RGB with zeros, alpha with its last
    row and column."""
    c, h, w = prev.shape
    m = pad_multiple(scale)
    hp, wp = -(-h // m) * m, -(-w // m) * m
    out = torch.empty((2, c, hp, wp), dtype=F32, device=prev.device)
    out[:, :3, h:].zero_()
    out[:, :3, :h, w:].zero_()
    out[0, :, :h, :w].copy_(prev)
    out[1, :, :h, :w].copy_(curr)
    out[:, 3:, h:, :w] = out[:, 3:, h - 1:h, :w]
    out[:, 3:, :, w:] = out[:, 3:, :, w - 1:w]
    return out
