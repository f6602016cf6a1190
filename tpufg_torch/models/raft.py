"""RAFT (Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for
Optical Flow", ECCV 2020, arXiv:2003.12039; github.com/princeton-vl/RAFT,
``core/raft.py``, ``update.py``, ``extractor.py``, ``corr.py``,
``utils/utils.py``), inference only, on the card: the learned motion of
the port's learned path, the flow from prev to curr at full size.

- **Input**: ``2 x - 1`` of the RGB frame in [0, 1], padded as
  ``InputPadder`` pads (replicate, to a multiple of 8, split between the
  two sides).
- **BasicEncoder** (``fnet`` with instance norm, affine off, eps 1e-5;
  ``cnet`` with eval-mode batch norm): ``conv1`` 7x7/s2 -> 64, norm, ReLU;
  ``layer1`` (64, s1), ``layer2`` (96, s2), ``layer3`` (128, s2), each two
  ResidualBlocks (``y = relu(n1(c1(x))); y = relu(n2(c2(y)))``; where the
  stride is not 1, ``x = n3(conv1x1_s(x))``; ``relu(x + y)``); ``conv2``
  1x1 -> 256 at 1/8 size.  ``cnet``'s output splits into the hidden state
  ``net = tanh([:128])`` and the context ``inp = relu([128:])``.
- **Correlation**: ``fmap1^T fmap2 / 16`` for every pair of 1/8 positions,
  then 3 levels of ``avg_pool2d(2, 2)``; the lookup
  (``kernels/corr_lookup.py``) samples a 9 x 9 window of radius 4 on each
  level around the current coordinates, 324 channels.
- **Update** x 12 (:data:`ITERS`): the motion encoder (``convc1`` 1x1
  324 -> 256, ``convc2`` 3x3 -> 192; ``convf1`` 7x7 2 -> 128, ``convf2``
  3x3 -> 64; ``conv`` 3x3 256 -> 126, the flow appended), the separable
  ConvGRU over ``[h, inp, motion]`` (1x5, then 5x1: ``z``, ``r``, ``q``,
  ``h = (1 - z) h + z q``), the flow head (3x3 128 -> 256, ReLU, 3x3 -> 2)
  added to the coordinates.
- **Upsampling**: after the last update, ``mask = 0.25 mask_head(h)`` (3x3
  -> 256, ReLU, 1x1 -> 576) and the convex combination
  (``kernels/convex_upsample.py``, which applies the 0.25) of 8 x the
  flow.  The published code
  computes the mask and the upsampling at every update and uses the last;
  computing them once gives the same flow.

Each frame's ``fnet`` features and ``cnet`` state are its stream cache
(:func:`frame_cache`): computed once, as curr, and reused as prev by the
next pair.  On the card ``engine/pipeline.py``'s ``RaftFlow`` replays the
flow (curr's encoders, the pyramid, the updates) as one CUDA graph.

Precision (departures from the published f32 model): every conv takes bf16
weights and inputs on cuDNN (f32 accumulation, channels-last) without its
bias and stores bf16; the bias is added to that and rounded again, as
PyTorch adds it, in one pass with the ReLU that follows
(``kernels/prelu.py``'s ``bias_prelu``, slope 0, or 1 for the bias
alone).  The norms compute in f32 and store bf16: the instance norm as a
training-mode batch norm of a batch of one (the same statistics), the
batch norm in eval mode from its running statistics.  The residual sums
are bf16.  The features are bf16; the correlation multiplies them exactly
and sums in f32, and the volume and its pyramid are f32 (the published
code casts the features to f32 first; ``kernels/corr_pool.py`` pools the
three levels in one pass).  The lookup's output is bf16.  The hidden
state, the gates (``kernels/raft_gru.py``: two passes a half of the GRU),
the coordinates, the flows, the softmax, the upsampling and the warps are
f32.  Channel counts are padded to multiples of 8 with zero weights (the
lookup's 324, the flow's 2, the motion conv's 126, the flow head's 2, the
frame's 3).

Weights (:func:`load`): the published state dict (``fnet.*``, ``cnet.*``
with the batch norms' running statistics, ``update_block.*``; a
``module.`` prefix stripped, ``num_batches_tracked`` and the ``norm3``
aliases of ``downsample.1`` dropped) from a ``.pth`` / ``.pt`` file
(``torch.load(weights_only=True)``) or an ``.npz`` of the same keys, or a
seeded recipe (``.json``, ``checkpoints/raft_seed.json``) from which
:func:`draw` makes them with NumPy.
"""

from __future__ import annotations

import functools
import json
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.convex_upsample import convex_upsample
from tpufg_torch.kernels.corr_lookup import corr_lookup
from tpufg_torch.kernels.corr_pool import corr_pool
from tpufg_torch.kernels.pack import pack_nhwc
from tpufg_torch.kernels.prelu import bias_prelu
from tpufg_torch.kernels.raft_gru import gru_gates, gru_update

F32 = torch.float32
BF16 = torch.bfloat16
CL = torch.channels_last

ARCH = "raft"
ITERS = 12          # train.py --iters, torchvision's num_flow_updates
HIDDEN = CONTEXT = 128
EPS = 1e-5
UB = "update_block"
# the layers the recipe draws with a gain instead of He-normal
GAINED = ("fnet.conv2", "cnet.conv2", f"{UB}.gru.convq1", f"{UB}.gru.convq2",
          f"{UB}.flow_head.conv2", f"{UB}.mask.2")
_BN = ("weight", "bias", "running_mean", "running_var")
_STAGES = (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 2))


# ------------------------------------------------------------------ weights

class RAFTParams(dict):
    """RAFT's weights: {published state-dict key: array or tensor}, tagged
    by its type so the learned path can tell it from the other heads."""


def _conv(out: dict, key: str, cout: int, cin: int, kh: int, kw: int):
    out[f"{key}.weight"] = (cout, cin, kh, kw)
    out[f"{key}.bias"] = (cout,)


def _encoder(out: dict, pre: str, batch: bool) -> None:
    def norm(key, c):
        if batch:
            out.update({f"{key}.{k}": (c,) for k in _BN})

    norm(f"{pre}.norm1", 64)
    _conv(out, f"{pre}.conv1", 64, 3, 7, 7)
    cin = 64
    for name, dim, stride in _STAGES:
        for i, (a, s) in enumerate(((cin, stride), (dim, 1))):
            k = f"{pre}.{name}.{i}"
            _conv(out, f"{k}.conv1", dim, a, 3, 3)
            _conv(out, f"{k}.conv2", dim, dim, 3, 3)
            norm(f"{k}.norm1", dim)
            norm(f"{k}.norm2", dim)
            if s != 1:
                _conv(out, f"{k}.downsample.0", dim, a, 1, 1)
                norm(f"{k}.downsample.1", dim)
        cin = dim
    _conv(out, f"{pre}.conv2", 256, 128, 1, 1)


@functools.lru_cache(maxsize=1)
def layer_shapes() -> dict:
    """{key: shape} of the published state dict, in the modules' order,
    without ``num_batches_tracked`` and the ``norm3`` aliases."""
    out: dict = {}
    _encoder(out, "fnet", False)
    _encoder(out, "cnet", True)
    e = f"{UB}.encoder"
    _conv(out, f"{e}.convc1", 256, 324, 1, 1)
    _conv(out, f"{e}.convc2", 192, 256, 3, 3)
    _conv(out, f"{e}.convf1", 128, 2, 7, 7)
    _conv(out, f"{e}.convf2", 64, 128, 3, 3)
    _conv(out, f"{e}.conv", 126, 256, 3, 3)
    for half, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for g in "zrq":
            _conv(out, f"{UB}.gru.conv{g}{half}", HIDDEN, 384, kh, kw)
    _conv(out, f"{UB}.flow_head.conv1", 256, 128, 3, 3)
    _conv(out, f"{UB}.flow_head.conv2", 2, 256, 3, 3)
    _conv(out, f"{UB}.mask.0", 256, 128, 3, 3)
    _conv(out, f"{UB}.mask.2", 576, 256, 1, 1)
    return out


def n_params(params: dict) -> int:
    """Learnable parameters (the running statistics left out)."""
    return sum(int(np.prod(v.shape)) for k, v in params.items()
               if not k.endswith(("running_mean", "running_var")))


def draw(recipe: dict) -> RAFTParams:
    """The weights a seeded recipe names, drawn with NumPy's PCG64 from
    ``recipe["seed"]``: in :func:`layer_shapes` order, each conv weight
    ``standard_normal(shape, float32) * std`` (He-normal for ReLU, ``std =
    sqrt(2 / fan_in)``, or ``gain / sqrt(fan_in)`` for the :data:`GAINED`
    layers), biases ``init.bias``; batch norms weight 1, bias 0, running
    mean 0, running variance 1."""
    init = recipe["init"]
    gains = init["gains"]
    rng = np.random.default_rng(int(recipe["seed"]))
    fill = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
            "running_var": 1.0}
    out = RAFTParams()
    for key, shape in layer_shapes().items():
        layer, leaf = key.rsplit(".", 1)
        if len(shape) == 4:
            fan = int(np.prod(shape[1:]))
            std = (float(gains[layer]) / np.sqrt(fan) if layer in gains
                   else np.sqrt(2.0 / fan))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
        elif leaf == "bias" and not _is_norm(layer):
            out[key] = np.full(shape, float(init["bias"]), np.float32)
        else:
            out[key] = np.full(shape, fill[leaf], np.float32)
    return out


def _is_norm(layer: str) -> bool:
    return layer.rsplit(".", 1)[-1].startswith("norm") or layer.endswith(
        "downsample.1")


def _check_recipe(recipe: dict, path: str) -> None:
    if recipe.get("architecture") != ARCH:
        raise ValueError(f"{path}: architecture "
                         f"{recipe.get('architecture')!r}, expected {ARCH!r}")
    init = recipe.get("init", {})
    for field in ("bias", "gains"):
        if field not in init:
            raise ValueError(f"{path}: init.{field} missing")
    if not isinstance(recipe.get("seed"), int):
        raise ValueError(f"{path}: seed must be an integer")
    if sorted(init["gains"]) != sorted(GAINED):
        raise ValueError(f"{path}: init.gains {sorted(init['gains'])}, "
                         f"expected {sorted(GAINED)}")


def _read_state(path: str) -> dict:
    """{key: array} of a state-dict file, as stored."""
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
        out[k] = v.numpy()
    return out


def _dropped(key: str) -> bool:
    return key.endswith(".num_batches_tracked") or ".norm3." in key


def from_state_dict(state: dict, where: str = "state dict") -> RAFTParams:
    """The published layout held to :func:`layer_shapes`: a ``module.``
    prefix stripped, ``num_batches_tracked`` and the ``norm3`` aliases
    dropped; a missing or unknown key, or a wrong shape or dtype, raises
    ValueError naming it."""
    shapes = layer_shapes()
    out = {}
    for key, arr in state.items():
        k = key[len("module."):] if key.startswith("module.") else key
        if _dropped(k):
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
    return RAFTParams((k, out[k]) for k in shapes)


def load(path: str) -> RAFTParams:
    """The weights of a recipe (``.json``), an ``.npz`` of the published
    keys, or a published ``.pth`` / ``.pt`` state dict."""
    if path.endswith(".json"):
        with open(path) as f:
            recipe = json.load(f)
        _check_recipe(recipe, path)
        return draw(recipe)
    return from_state_dict(_read_state(path), path)


def _state_keys(path: str):
    """The key names of a state-dict file, its arrays left unread (an
    ``.npz``'s index; a ``.pth`` mapped, not loaded)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return list(data.files)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return list(sd) if isinstance(sd, dict) else []


def looks_like(path: str) -> bool:
    """Whether ``path`` holds RAFT weights: a recipe of this architecture,
    or a state dict with ``fnet.conv1.weight``."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f).get("architecture") == ARCH
    if not path.endswith((".npz", ".pth", ".pt")):
        return False
    try:
        keys = _state_keys(path)
    except (ValueError, OSError, RuntimeError, pickle.UnpicklingError):
        return False
    return any(k in keys for k in ("fnet.conv1.weight",
                                   "module.fnet.conv1.weight"))


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _as_f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32) if not isinstance(
        v, torch.Tensor) else v, dtype=F32)


def to_device(params: RAFTParams, device: torch.device) -> RAFTParams:
    """The program's copy on ``device``: each conv's weight (channels-last)
    and bias in bf16, input and output channels padded to multiples of 8
    with zeros; the GRU's ``z`` and ``r`` convs of each half as one conv
    (``convzr1``, ``convzr2``: 256 outputs, ``z`` first); the batch norms'
    four vectors in f32; ``@relu`` and ``@linear``, bf16 slopes 0 and 1 for
    :func:`kernels.prelu.bias_prelu` (a ReLU, or the bias add alone).
    Params already so are returned as they are."""
    done = params.get("@relu")
    if isinstance(done, torch.Tensor) and done.device == device:
        return params
    p = {k: _as_f32(v) for k, v in params.items()}
    for half in "12":
        g = f"{UB}.gru.conv"
        for leaf in ("weight", "bias"):
            p[f"{g}zr{half}.{leaf}"] = torch.cat(
                [p.pop(f"{g}z{half}.{leaf}"), p.pop(f"{g}r{half}.{leaf}")])
    out = RAFTParams()
    for key in list(p):
        layer, leaf = key.rsplit(".", 1)
        if leaf != "weight" or p[key].ndim != 4:
            continue
        w, b = p[key], p[f"{layer}.bias"]
        co, ci = w.shape[:2]
        w = F.pad(w, (0, 0, 0, 0, 0, _pad8(ci) - ci, 0, _pad8(co) - co))
        out[key] = w.to(device=device, dtype=BF16).contiguous(
            memory_format=CL)
        out[f"{layer}.bias"] = F.pad(b, (0, _pad8(co) - co)).to(
            device=device, dtype=BF16)
    for key in p:
        if key.endswith(".running_var"):
            layer = key[:-len(".running_var")]
            for leaf in _BN:
                out[f"{layer}.{leaf}"] = p[f"{layer}.{leaf}"].to(device)
    widest = max(t.shape[0] for k, t in out.items() if k.endswith(".bias"))
    out["@relu"] = torch.zeros(widest, dtype=BF16, device=device)
    out["@linear"] = torch.ones(widest, dtype=BF16, device=device)
    return out


# -------------------------------------------------------------------- model

def padding(h: int, w: int) -> tuple[int, int, int, int]:
    """``InputPadder``'s replicate pad (left, right, top, bottom) of an
    h x w frame to a multiple of 8 ('sintel' mode: split between sides)."""
    ph, pw = (-h) % 8, (-w) % 8
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


def pad_rgb(x: torch.Tensor) -> torch.Tensor:
    """Planar f32 [>= 3, h, w] -> its RGB padded by :func:`padding`, [3,
    H, W]."""
    pad = padding(*x.shape[1:])
    rgb = x[:3].to(F32)
    return F.pad(rgb[None], pad, mode="replicate")[0] if any(pad) else rgb


def _conv_only(p: dict, key: str, x: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """A published conv without its bias on a bf16 channels-last input
    (cuDNN, f32 accumulation, bf16 out)."""
    w = p[f"{key}.weight"]
    kh, kw = w.shape[2:]
    return F.conv2d(x, w, None, stride, (kh // 2, kw // 2))


def _c(p: dict, key: str, x: torch.Tensor, stride: int = 1,
       relu: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """A published conv: :func:`_conv_only`, then the bias add rounded to bf16
    (and the ReLU) in one pass, in place or into ``out``, a channel slice
    of a wider tensor."""
    y = _conv_only(p, key, x, stride)
    return bias_prelu(y, p[f"{key}.bias"],
                      p["@relu" if relu else "@linear"][:y.shape[1]], out)


def _bn(y: torch.Tensor, *args) -> torch.Tensor:
    """``F.batch_norm(y, *args)`` of a bf16 tensor, normalised in f32 and
    stored bf16: on the card in one pass of ATen's kernel, which reads bf16
    and computes in f32; on the CPU, whose bf16 batch norm normalises in
    bf16, on an f32 copy."""
    if y.device.type == "cpu":
        return F.batch_norm(y.float(), *args).to(BF16)
    return F.batch_norm(y, *args)


def _instance_norm(y: torch.Tensor) -> torch.Tensor:
    """``InstanceNorm2d`` (affine off) of a batch of one: each channel's
    statistics over the frame in f32, as a training-mode batch norm
    computes them."""
    return _bn(y, None, None, None, None, True, 0.0, EPS)


def _batch_norm(p: dict, key: str, y: torch.Tensor) -> torch.Tensor:
    """Eval-mode ``BatchNorm2d`` with its running statistics."""
    return _bn(y, p[f"{key}.running_mean"], p[f"{key}.running_var"],
               p[f"{key}.weight"], p[f"{key}.bias"], False, 0.0, EPS)


def _encoder_fwd(p: dict, pre: str, x: torch.Tensor) -> torch.Tensor:
    """A BasicEncoder on the packed frame -> bf16 channels-last [1, 256,
    H / 8, W / 8]."""
    if pre == "cnet":
        def norm(key, y):
            return _batch_norm(p, key, y)
    else:
        def norm(key, y):
            return _instance_norm(y)

    y = norm(f"{pre}.norm1", _c(p, f"{pre}.conv1", x, 2)).relu_()
    for name, _, stride in _STAGES:
        for i, s in enumerate((stride, 1)):
            k = f"{pre}.{name}.{i}"
            z = norm(f"{k}.norm1", _c(p, f"{k}.conv1", y, s)).relu_()
            z = norm(f"{k}.norm2", _c(p, f"{k}.conv2", z)).relu_()
            if s != 1:
                y = norm(f"{k}.downsample.1", _c(p, f"{k}.downsample.0", y,
                                                 s))
            y = (y + z).relu_()
    return _c(p, f"{pre}.conv2", y)


def frame_cache(p: dict, rgb: torch.Tensor) -> tuple:
    """A padded f32 RGB frame [3, H, W]'s stream cache: (``fnet``'s
    features, bf16 channels-last [1, 256, H / 8, W / 8]; ``cnet``'s hidden
    state ``tanh``, f32 channels-last [1, 128, ..]; its context ``relu``,
    bf16 channels-last [1, 128, ..])."""
    x = pack_nhwc([(2 * rgb - 1)[None]], 8)
    fmap = _encoder_fwd(p, "fnet", x)
    c = _encoder_fwd(p, "cnet", x)
    net = torch.tanh(c[:, :HIDDEN].float()).contiguous(memory_format=CL)
    inp = c[:, HIDDEN:].relu().contiguous(memory_format=CL)
    return fmap, net, inp


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> list:
    """The all-pairs correlation of two frames' features, f32 [h * w, 1,
    h, w] (pixel p's map over every position), and its 3 pooled levels.
    The features are bf16, so their products are exact in f32: on the card
    a bf16 matrix product that sums in f32 (the ``1 / 16`` on fmap1, a
    power of two, changes no rounding), on the CPU the same product in
    f32."""
    _, c, h, w = fmap1.shape
    a = fmap1.permute(0, 2, 3, 1).reshape(h * w, c) * 0.0625
    b = fmap2.permute(0, 2, 3, 1).reshape(h * w, c)
    if a.device.type == "cpu":
        corr = a.float() @ b.float().t()
    else:
        corr = torch.mm(a, b.t(), out_dtype=F32)
    level0 = corr.view(h * w, 1, h, w)
    return [level0, *corr_pool(level0)]


def coords_grid(h: int, w: int, device: torch.device) -> torch.Tensor:
    """f32 [1, 2, h, w]: each position's (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys])[None].float()


def _gru_half(p: dict, half: str, h: torch.Tensor, buf: torch.Tensor,
              copy: torch.Tensor | None = None) -> None:
    """One half of the SepConvGRU, ``h`` (f32) updated in place; ``buf``
    holds ``[h, inp, motion]`` (bf16 channels-last, 384 channels) and
    takes the new ``h`` in its first 128 (and ``copy``, where given)."""
    g = f"{UB}.gru.conv"
    zr = _conv_only(p, f"{g}zr{half}", buf)
    gru_gates(zr, p[f"{g}zr{half}.bias"], h, buf[:, :HIDDEN])
    q = _conv_only(p, f"{g}q{half}", buf)
    gru_update(zr, p[f"{g}zr{half}.bias"], q, p[f"{g}q{half}.bias"], h,
               buf[:, :HIDDEN], copy)


def refine(p: dict, cache_prev: tuple, pyramid: list) -> torch.Tensor:
    """The 12 updates from prev's hidden state and context over the
    correlation pyramid, then the convex upsampling -> the flow at the
    padded size, f32 [1, 2, H, W]."""
    _, net, inp = cache_prev
    _, _, h, w = inp.shape
    dev = inp.device
    e = f"{UB}.encoder"
    coords0 = coords_grid(h, w, dev)
    coords1 = coords0.clone()

    def buffer(c):
        return torch.empty((1, c, h, w), dtype=BF16, device=dev,
                           memory_format=CL)

    flo = buffer(8)
    flo[:, 2:].zero_()
    cor_flo = buffer(256)
    gru_in = buffer(3 * HIDDEN)      # [h, inp, motion features, flow]
    x = buffer(HIDDEN)               # h in bf16, the heads' input
    hid = net.clone()
    gru_in[:, :HIDDEN].copy_(hid)
    gru_in[:, HIDDEN:2 * HIDDEN].copy_(inp)
    for _ in range(ITERS):
        corr = corr_lookup(pyramid, coords1)
        flow = coords1 - coords0
        flo[:, :2].copy_(flow)
        cor = _c(p, f"{e}.convc1", corr, relu=True)
        _c(p, f"{e}.convc2", cor, relu=True, out=cor_flo[:, :192])
        f = _c(p, f"{e}.convf1", flo, relu=True)
        _c(p, f"{e}.convf2", f, relu=True, out=cor_flo[:, 192:])
        # 126 channels and 2 of zero weights, which the flow overwrites
        _c(p, f"{e}.conv", cor_flo, relu=True, out=gru_in[:, 2 * HIDDEN:])
        gru_in[:, 3 * HIDDEN - 2:].copy_(flow)
        _gru_half(p, "1", hid, gru_in)
        _gru_half(p, "2", hid, gru_in, x)
        d = _c(p, f"{UB}.flow_head.conv2",
               _c(p, f"{UB}.flow_head.conv1", x, relu=True))
        coords1 = coords1 + d[:, :2].float()
    mask = _c(p, f"{UB}.mask.2", _c(p, f"{UB}.mask.0", x, relu=True))
    return convex_upsample((coords1 - coords0).contiguous(), mask)


def crop(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The padded flow [1, 2, H, W] cut back to the frame, [2, h, w]
    (``InputPadder.unpad``)."""
    left, _, top, _ = padding(h, w)
    return flow[0, :, top:top + h, left:left + w]
