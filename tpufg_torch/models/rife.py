"""Learned interpolation head (RIFE-style), inference only.

Counterpart of ``tpufg/models/rife.py`` for the functions the engine's
learned step runs (BASELINE config 5), on planar [C, H, W] frames without
a batch axis.  The v3 family is ported: v3, v3d (stage 2 also reads the
warped difference; ``checkpoints/head64_v4.npz``, the bundled default) and
v3c (a residual second coarse body).  RIFE's own network (IFNet,
Contextnet and U-Net) lives in ``models/ifnet.py``, and RAFT's optical
flow in ``models/raft.py``; :func:`load_params` recognises their weights
and the head functions here name and admit them.
Per frame pair of a v3 head:

1. per frame, the quarter frame (:func:`_down4_mean`) and the encoder
   features (:func:`encode3`: enc1 on the conv3x3_s2 kernel, enc2 a plain
   conv), computed once per frame by the engine's stream cache;
2. :func:`trunk_fast`: stage 1 at 1/8 (enc3, c_body [, c_body2], c_head),
   the 2x upsample, the 8-px integer coarse warp of both quarter frames,
   and stage 2 (r_in -> r_body -> r_head) as one conv3x3_chain launch;
3. :func:`tails_fast`: the lattice flow sample, the mask upsample (two band
   matmuls), and per time point the fractional single warps at block 16
   and the occlusion-weighted fusion.

As in tpufg, the engine runs this path in bf16 whatever ``--dtype`` says,
so every function here computes in bf16 (:data:`DTYPE`).  v1
(``head64.npz``) and v2 (``head64_v2.npz``) load but raise
NotImplementedError in :func:`trunk_fast`.  The two conv kernels and the
warp kernel take their plain versions as ``kernels.common.plain_versions``
says.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpufg_torch.kernels.conv import conv3x3_chain, conv3x3_s2, conv_same
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul
from tpufg_torch.models import ifnet, raft
from tpufg_torch.utils.checkpoint import load_layers

F32 = torch.float32
BF16 = torch.bfloat16

HIDDEN = 64
SCALE = 4  # flow predicted at 1/SCALE resolution
DTYPE = BF16  # the learned path's compute dtype
# the tail's single warps: 16-px blocks (the 4x4 lattice of 1/SCALE
# resolution flows), offsets clamped to +-8 px
TAIL_BLOCK = 4 * SCALE
TAIL_RADIUS = 8

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ------------------------------------------------------------------ weights

def bundled_checkpoint() -> Optional[str]:
    """Path of the newest bundled head in ``checkpoints/``, or None (the
    precedence of ``tpufg.models.rife.bundled_checkpoint``)."""
    for name in ("head64_v4.npz", "head64_v3.npz", "head64_v2.npz",
                 "head64.npz"):
        p = os.path.join(_REPO, "checkpoints", name)
        if os.path.exists(p):
            return p
    return None


def _layer_shapes(kind: str, h: int, r_in_ch: int = 13) -> dict:
    """{layer: (out, in)} of each architecture (tpufg's init_params,
    init_params2, init_params3)."""
    if kind == "v1":
        return {"enc1": (h // 2, 8), "enc2": (h, h // 2), "body1": (h, h),
                "body2": (h, h), "head": (5, h)}
    stages = {"enc3": (h, h), "c_body": (h, h), "c_head": (5, h),
              "r_body": (h, h), "r_head": (5, h)}
    if kind == "v2":
        return {"enc1": (h // 2, 8), "enc2": (h, h // 2),
                "r_in": (h, h + 13), **stages}
    return {"enc1": (h // 2, 4), "enc2": (h // 2, h // 2),
            "r_in": (h, r_in_ch), **stages}


def load_params(path: str) -> dict:
    """The learned head in ``path``.  RAFT's weights (a seeded recipe
    ``.json`` of its architecture, or a state dict with ``fnet.*`` keys)
    load through :func:`tpufg_torch.models.raft.load` as
    :class:`raft.RAFTParams`; RIFE's IFNet weights (a seeded
    recipe ``.json``, a published ``.pkl`` / ``.pth`` / ``.pt`` state
    dict, or an ``.npz`` of its keys without ``__treedef__``) load through
    :func:`tpufg_torch.models.ifnet.load` as :class:`ifnet.IFNetParams`.
    Otherwise a checkpoint written by ``tpufg.utils.checkpoint.save_pytree`` as
    ``{layer: {"w", "b"}}`` numpy f32 arrays, held to the architecture
    ``tpufg.models.rife.load_params`` infers: 16 leaves are v2 or v3
    (``enc1.w``'s input channels 8 or 4; v3's ``r_in.w`` takes 13, or 17
    for v3d), 18 leaves v3c, anything else v1.  Raises ValueError for a
    file that does not fit."""
    if raft.looks_like(path):
        return raft.load(path)
    if ifnet.looks_like(path):
        return ifnet.load(path)
    layers = load_layers(path)
    # leaf 0: a body bias in every layout's sorted key order
    hidden = int(layers[min(layers)]["b"].shape[0])
    n_leaves = 2 * len(layers)

    def in_ch(name):
        w = layers.get(name, {}).get("w")
        return w.shape[1] if w is not None and w.ndim == 4 else None

    r_in_ch = 17 if in_ch("r_in") == 17 else 13
    if n_leaves == 16 and in_ch("enc1") == 4:
        shapes = _layer_shapes("v3", hidden, r_in_ch)
    elif n_leaves == 16:
        shapes = _layer_shapes("v2", hidden)
    elif n_leaves == 18:
        shapes = {**_layer_shapes("v3", hidden, r_in_ch),
                  "c_body2": (hidden, hidden)}
    else:
        shapes = _layer_shapes("v1", hidden)
    if sorted(layers) != sorted(shapes):
        raise ValueError(f"{path}: layers {sorted(layers)} do not match "
                         f"{sorted(shapes)}")
    for name, (co, ci) in shapes.items():
        for leaf, want in (("w", (co, ci, 3, 3)), ("b", (co,))):
            arr = layers[name][leaf]
            if tuple(arr.shape) != want or arr.dtype != np.float32:
                raise ValueError(f"{path}: {name}.{leaf} is {arr.dtype} "
                                 f"{arr.shape}, expected float32 {want}")
    return layers


def params_to_torch(tree: dict, device: torch.device | str) -> dict:
    """``{layer: {"w", "b"}}`` of numpy arrays or tensors -> f32 tensors
    on ``device`` (tensors already there are not copied); IFNet and RAFT
    weights -> :func:`ifnet.to_device`'s and :func:`raft.to_device`'s bf16
    tensors."""
    if is_ifnet(tree):
        return ifnet.to_device(tree, torch.device(device))
    if is_raft(tree):
        return raft.to_device(tree, torch.device(device))
    def conv(v):
        if not isinstance(v, torch.Tensor):
            v = np.array(v, np.float32)  # a copy torch may own and write
        return torch.as_tensor(v, dtype=F32, device=device)

    return {name: {k: conv(v) for k, v in layer.items()}
            for name, layer in tree.items()}


def is_ifnet(params: dict) -> bool:
    """RIFE's own network (``models/ifnet.py``)."""
    return isinstance(params, ifnet.IFNetParams)


def is_raft(params: dict) -> bool:
    """RAFT's optical flow (``models/raft.py``)."""
    return isinstance(params, raft.RAFTParams)


def is_v2(params: dict) -> bool:
    """Two-stage head with the pair-joint (8-channel) encoder."""
    return "enc3" in params and params["enc1"]["w"].shape[1] == 8


def is_v3(params: dict) -> bool:
    """Streaming two-stage head (per-frame, 4-channel encoder)."""
    return "enc3" in params and params["enc1"]["w"].shape[1] == 4


def has_stage2_diff(params: dict) -> bool:
    """v3d: stage 2 also reads the warped difference (r_in takes 17)."""
    return is_v3(params) and params["r_in"]["w"].shape[1] == 17


def has_coarse_body2(params: dict) -> bool:
    """v3c: the residual second coarse-body conv is present."""
    return is_v3(params) and "c_body2" in params


def head_name(params: dict) -> str:
    """v1, v2, v3, v3d, v3c, v3dc, ifnet or raft."""
    if is_ifnet(params):
        return "ifnet"
    if is_raft(params):
        return "raft"
    if is_v3(params):
        return ("v3" + ("d" if has_stage2_diff(params) else "")
                + ("c" if has_coarse_body2(params) else ""))
    return "v2" if is_v2(params) else "v1"


def check_ported_head(params: dict) -> None:
    """Raise NotImplementedError naming a head outside the v3 family, the
    IFNet and RAFT."""
    if not (is_v3(params) or is_ifnet(params) or is_raft(params)):
        raise NotImplementedError(
            f"learned head {head_name(params)}: not yet ported to "
            "tpufg_torch (the v3 family, RIFE's IFNet and RAFT run)")


def _check_v3(params: dict) -> None:
    """The trunk and tails run the v3 family only."""
    if not is_v3(params):
        raise NotImplementedError(
            f"learned head {head_name(params)}: the v3 trunk and tails do "
            "not run it (not yet ported to tpufg_torch)")


# -------------------------------------------------------------------- trunk

def _down4_mean(x: torch.Tensor) -> torch.Tensor:
    """4x4 box mean of [C, H, W]: the 16 taps summed in row-major order,
    then times fl(1/16) — tpufg's reduce_window in the order its CPU
    backend sums (bitwise there)."""
    c, h, w = x.shape
    v = x.reshape(c, h // 4, 4, w // 4, 4)
    acc = v[:, :, 0, :, 0]
    for k in range(1, 16):
        acc = acc + v[:, :, k // 4, :, k % 4]
    return acc * (1.0 / 16.0)


def _up2(out: torch.Tensor) -> torch.Tensor:
    """Head output [5, h, w] -> [5, 2h, 2w] (``jax.image.resize``
    "bilinear": half-pixel centres, clamped at the borders); flow values
    double with the resolution, the mask logit does not."""
    _, h, w = out.shape
    up = F.interpolate(out[None], size=(2 * h, 2 * w), mode="bilinear",
                       align_corners=False)[0]
    return torch.cat([up[:4] * 2.0, up[4:]])


def encode3(params: dict, frame: torch.Tensor) -> torch.Tensor:
    """Per-frame encoder: [4, H, W] -> [h/2, H/4, W/4].  enc1 runs on the
    conv3x3_s2 kernel."""
    h1 = torch.relu(conv3x3_s2(frame.to(F32), params["enc1"]["w"],
                               params["enc1"]["b"], compute_dtype=DTYPE))
    return torch.relu(conv_same(h1, params["enc2"]["w"],
                                params["enc2"]["b"], 2, DTYPE))


def frame_cache(params: dict, frame: torch.Tensor):
    """A planar frame's stream cache (H, W multiples of 16): (quarter
    frame [C, H/4, W/4], encoder features [h/2, H/4, W/4])."""
    return _down4_mean(frame.to(F32)), encode3(params, frame)


def _edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-pad the last two axes of [C, H, W] by rows / cols at the end."""
    if not rows and not cols:
        return x
    return F.pad(x[None], (0, cols, 0, rows), mode="replicate")[0]


def _coarse_warp8(out0_4: torch.Tensor, p4: torch.Tensor,
                  c4: torch.Tensor):
    """Both quarter frames moved by the coarse flow rounded to whole
    pixels, one offset per 8-px block (sampled at the block centres,
    clamped to +-4 by the warp).  Frame rows and columns and the flow
    lattice are edge-padded to the block grid, and the result cropped.
    The warp runs on its CUDA kernel."""
    lat = out0_4[:, 4::8, 4::8]
    fp4 = torch.round(lat[0:2])
    fc4 = torch.round(lat[2:4])
    _, hq, wq = p4.shape
    hpad, wpad = (-hq) % 8, (-wq) % 8
    p4b, c4b = _edge_pad(p4, hpad, wpad), _edge_pad(c4, hpad, wpad)
    rpad = (hq + hpad) // 8 - fp4.shape[1]
    cpad = (wq + wpad) // 8 - fp4.shape[2]
    fp4, fc4 = _edge_pad(fp4, rpad, cpad), _edge_pad(fc4, rpad, cpad)
    kw = dict(single=True, block=8, search_radius=4, dtype=DTYPE,
              integer_offsets=True)
    p4w = warp_blend_matmul(p4b, p4b, fp4, **kw)[:, :hq, :wq]
    c4w = warp_blend_matmul(c4b, c4b, fc4, **kw)[:, :hq, :wq]
    return p4w, c4w


def _stage1(params: dict, f4p: torch.Tensor,
            f4c: torch.Tensor) -> torch.Tensor:
    """Coarse stage at 1/8 on both frames' features -> [5, H/8, W/8]
    (flows in 1/8-res pixels and the mask logit)."""
    f4 = torch.cat([f4p, f4c], 0)
    f8 = torch.relu(conv_same(f4, params["enc3"]["w"], params["enc3"]["b"],
                              2, DTYPE))
    g = torch.relu(conv_same(f8, params["c_body"]["w"],
                             params["c_body"]["b"], 1, DTYPE))
    if "c_body2" in params:
        # v3c's residual; jax.nn.gelu is the tanh approximation
        g = g + F.gelu(conv_same(g, params["c_body2"]["w"],
                                 params["c_body2"]["b"], 1, DTYPE),
                       approximate="tanh")
    # c_head runs in f32 in tpufg (its _conv's default dtype)
    return conv_same(g, params["c_head"]["w"], params["c_head"]["b"])


def _stage2(params: dict, p4w: torch.Tensor, c4w: torch.Tensor,
            out0_4: torch.Tensor) -> torch.Tensor:
    """The refining stage at 1/4: r_in -> relu -> r_body -> relu -> r_head
    over the warped quarter frames, the upsampled coarse output and (v3d)
    their difference, as one conv3x3_chain launch -> the residual
    [5, H/4, W/4]."""
    parts = [p4w, c4w, out0_4]
    if params["r_in"]["w"].shape[1] == 17:
        parts.append(p4w - c4w)   # v3d: the signed warped difference
    names = ("r_in", "r_body", "r_head")
    return conv3x3_chain(torch.cat(parts, 0),
                         tuple(params[n]["w"] for n in names),
                         tuple(params[n]["b"] for n in names),
                         (True, True, False), compute_dtype=DTYPE)


def _head3_raw(params: dict, p4: torch.Tensor, c4: torch.Tensor,
               f4p: torch.Tensor, f4c: torch.Tensor):
    """v3 trunk on the stream cache (quarter frames p4/c4 [C, H/4, W/4],
    features f4p/f4c [h/2, H/4, W/4]) -> (refined head output [5, H/4,
    W/4], coarse stage-1 output [5, H/8, W/8]); tpufg's fast branch."""
    out0 = _stage1(params, f4p, f4c)
    out0_4 = _up2(out0)
    p4w, c4w = _coarse_warp8(out0_4, p4, c4)
    return out0_4 + _stage2(params, p4w, c4w, out0_4), out0


def trunk_fast(params: dict, q_prev, q_curr) -> torch.Tensor:
    """The t-independent head output [5, H/4, W/4] of a frame pair from
    both frames' stream caches (:func:`frame_cache`).  Heads outside the
    v3 family raise NotImplementedError."""
    _check_v3(params)
    (p4, f4p), (c4, f4c) = q_prev, q_curr
    return _head3_raw(params, p4, c4, f4p, f4c)[0]


# --------------------------------------------------------------------- tail

def _band_mat(n_out: int, n_in: int, scale: int = SCALE,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """f32 [n_out, n_in] bilinear-upsample band matrix, tpufg's
    ``_band_mat`` (``jax.image.resize``'s half-sample-centred weights: out
    x reads in coordinate (x + 0.5)/scale - 0.5, a clamped 2-tap lerp),
    built on ``device``."""
    x = torch.arange(n_out, dtype=torch.float64, device=device)
    c = (x + 0.5) / scale - 0.5
    i0 = torch.floor(c)
    f = c - i0
    rows = x.long()
    r = torch.zeros((n_out, n_in), dtype=F32, device=device)
    r.index_put_((rows, i0.clamp(0, n_in - 1).long()), (1.0 - f).to(F32),
                 accumulate=True)
    r.index_put_((rows, (i0 + 1).clamp(0, n_in - 1).long()), f.to(F32),
                 accumulate=True)
    return r


def _flow_t_scales(t: float) -> tuple[float, float]:
    """Per-side scales of the midpoint-trained flows at time t: 2t toward
    prev, 2(1 - t) toward curr (exactly 1 at t = 0.5)."""
    return 2.0 * float(t), 2.0 * (1.0 - float(t))


def _fuse(warped_p: torch.Tensor, warped_c: torch.Tensor, mask: torch.Tensor,
          t: float) -> torch.Tensor:
    """Occlusion-weighted fusion biased by temporal position (f32)."""
    tt = float(np.float32(t))
    w_p = mask * (1.0 - tt)
    w_c = (1.0 - mask) * tt
    return (warped_p * w_p + warped_c * w_c) / (w_p + w_c + 1e-6)


def tails_fast(params: dict, out: torch.Tensor, prev: torch.Tensor,
               curr: torch.Tensor, ts) -> list[torch.Tensor]:
    """The in-between frame at each t in ``ts`` from the head output
    ``out`` [5, H/4, W/4] and the planar f32 pair [C, H, W] (H, W
    multiples of 16).

    The lattice flow is sampled in closed form at the block centres (head
    rows 1 + 4k and 2 + 4k weighted 0.375 / 0.625, the same for columns),
    the mask logit upsampled by two f32 band matmuls and passed through a
    sigmoid; per t the flows are scaled per side, each frame moves by a
    single warp at 16-px blocks with fractional offsets (the v3
    heads' tail; v1's rounds its flows to whole pixels, see ROADMAP A7b;
    the warp's CUDA kernel), and
    :func:`_fuse` blends.
    """
    _check_v3(params)
    hq, wq = out.shape[1:]
    nh, nw = hq // 4, wq // 4
    ry = out[:, 1::4][:, :nh] * 0.375 + out[:, 2::4][:, :nh] * 0.625
    lat = (ry[:, :, 1::4][:, :, :nw] * 0.375
           + ry[:, :, 2::4][:, :, :nw] * 0.625)
    r = _band_mat(hq * SCALE, hq, device=out.device)
    c = _band_mat(wq * SCALE, wq, device=out.device)
    mask = torch.sigmoid(torch.matmul(torch.matmul(r, out[4]), c.T))[None]
    kw = dict(single=True, block=TAIL_BLOCK, search_radius=TAIL_RADIUS,
              dtype=DTYPE)
    fused = []
    for t in ts:
        sp, sc = _flow_t_scales(t)
        fp = lat[0:2] * float(np.float32(SCALE * sp))
        fc = lat[2:4] * float(np.float32(SCALE * sc))
        warped_p = warp_blend_matmul(prev, prev, fp, **kw)
        warped_c = warp_blend_matmul(curr, curr, fc, **kw)
        fused.append(_fuse(warped_p, warped_c, mask, t))
    return fused
