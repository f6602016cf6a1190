"""The learned interpolation head of config 5 (the v3 family, RIFE-style),
from the checkpoint file.

Per frame: the quarter frame (4x4 mean, its 16 taps added row-major, times
1/16) and the encoder (enc1, enc2: stride-2 3x3 convs, relu).  Per pair:
stage 1 at 1/8 (enc3 stride 2, c_body, [c_body2,] c_head), a bilinear 2x
upsample whose flows double, both quarter frames moved by the coarse flow
rounded to whole pixels per 8-px block, stage 2 (r_in -> r_body -> r_head
over the warped quarter frames, the upsampled coarse output and, for v3d,
their difference), the sum of both stages; then the tail: the flows sampled
at the 16-px block centres, the mask logit upsampled by two f32 band
matmuls and a sigmoid, each frame moved by its scaled flow with a
fractional warp, and the occlusion-weighted fusion.

Every conv computes ``conv(q(x), q(w)) + b`` in f32 with XLA's SAME
padding (for stride 2 on an even size: 0 in front, 1 behind), where ``q``
rounds to the compute type; c_head runs in f32.  TF32 is off for every f32
conv and matmul.
"""

from __future__ import annotations

import contextlib
import json
import re

import numpy as np
import torch
import torch.nn.functional as F

from fgbench.reference.motion import warp_single

F32 = torch.float32
SCALE = 4
TAIL_BLOCK = 16
TAIL_RADIUS = 8

_LAYER = re.compile(r"'(\w+)': \{'b': \*, 'w': \*\}")


def read_tree(path: str) -> dict:
    """``{layer: {"w", "b"}}`` numpy arrays from a parameter file that
    stores leaf ``2k`` (layer k's bias) and ``2k + 1`` (its weight), the
    layers in sorted order, with the tree named in ``__treedef__``."""
    with np.load(path) as data:
        names = _LAYER.findall(json.loads(bytes(data["__treedef__"])
                                          .decode()))
        if not names or names != sorted(names):
            raise ValueError(f"{path}: not a {{layer: {{b, w}}}} tree")
        return {n: {"b": data[f"leaf_{2 * i}"],
                    "w": data[f"leaf_{2 * i + 1}"]}
                for i, n in enumerate(names)}


def load_checkpoint(path: str, device: torch.device) -> dict:
    """A v3-family head's layers as f32 tensors on ``device``."""
    tree = read_tree(path)
    if tree["enc1"]["w"].shape[1] != 4 or "enc3" not in tree:
        raise ValueError(f"{path}: not a v3-family head")
    return {n: {k: torch.as_tensor(np.array(v, np.float32), device=device)
                for k, v in layer.items()} for n, layer in tree.items()}


@contextlib.contextmanager
def no_tf32():
    """f32 convs and matmuls in f32, not TF32 (restored afterwards)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _same_pads(n: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + 3 - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, layer: dict, stride: int, q) -> torch.Tensor:
    """[Cin, H, W] -> f32 [Cout, ceil(H/s), ceil(W/s)]; ``q`` None: f32."""
    q = q or (lambda t: t)
    _, h, w = x.shape
    pt, pb = _same_pads(h, stride)
    pl, pr = _same_pads(w, stride)
    xr = F.pad(q(x.to(F32))[None], (pl, pr, pt, pb))
    y = F.conv2d(xr, q(layer["w"]), stride=stride)[0]
    return y + layer["b"][:, None, None]


def down4_mean(x: torch.Tensor) -> torch.Tensor:
    c, h, w = x.shape
    v = x.reshape(c, h // 4, 4, w // 4, 4)
    acc = v[:, :, 0, :, 0]
    for k in range(1, 16):
        acc = acc + v[:, :, k // 4, :, k % 4]
    return acc * (1.0 / 16.0)


def frame_cache(params: dict, frame: torch.Tensor, q):
    """A planar frame's (quarter frame, encoder features)."""
    h1 = torch.relu(conv(frame, params["enc1"], 2, q))
    return down4_mean(frame.to(F32)), torch.relu(
        conv(h1, params["enc2"], 2, q))


def _up2(out: torch.Tensor) -> torch.Tensor:
    _, h, w = out.shape
    up = F.interpolate(out[None], size=(2 * h, 2 * w), mode="bilinear",
                       align_corners=False)[0]
    return torch.cat([up[:4] * 2.0, up[4:]])


def _edge_pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if not rows and not cols:
        return x
    return F.pad(x[None], (0, cols, 0, rows), mode="replicate")[0]


def _coarse_warp8(out0_4: torch.Tensor, p4: torch.Tensor, c4: torch.Tensor,
                  q):
    lat = out0_4[:, 4::8, 4::8]
    fp4, fc4 = torch.round(lat[0:2]), torch.round(lat[2:4])
    _, hq, wq = p4.shape
    hpad, wpad = (-hq) % 8, (-wq) % 8
    p4b, c4b = _edge_pad(p4, hpad, wpad), _edge_pad(c4, hpad, wpad)
    rpad = (hq + hpad) // 8 - fp4.shape[1]
    cpad = (wq + wpad) // 8 - fp4.shape[2]
    fp4, fc4 = _edge_pad(fp4, rpad, cpad), _edge_pad(fc4, rpad, cpad)
    p4w = warp_single(p4b, fp4, 8, 4, q, integer=True)[:, :hq, :wq]
    c4w = warp_single(c4b, fc4, 8, 4, q, integer=True)[:, :hq, :wq]
    return p4w, c4w


def trunk(params: dict, cache_p, cache_c, q) -> torch.Tensor:
    """Both stages -> the head output [5, H/4, W/4]."""
    (p4, f4p), (c4, f4c) = cache_p, cache_c
    f8 = torch.relu(conv(torch.cat([f4p, f4c], 0), params["enc3"], 2, q))
    g = torch.relu(conv(f8, params["c_body"], 1, q))
    if "c_body2" in params:
        g = g + F.gelu(conv(g, params["c_body2"], 1, q), approximate="tanh")
    out0_4 = _up2(conv(g, params["c_head"], 1, None))
    p4w, c4w = _coarse_warp8(out0_4, p4, c4, q)
    parts = [p4w, c4w, out0_4]
    if params["r_in"]["w"].shape[1] == 17:
        parts.append(p4w - c4w)
    a = torch.cat(parts, 0)
    for name, relu in (("r_in", True), ("r_body", True), ("r_head", False)):
        a = conv(a, params[name], 1, q)
        if relu:
            a = torch.relu(a)
    return out0_4 + a


def _band_mat(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    x = torch.arange(n_out, dtype=torch.float64, device=device)
    c = (x + 0.5) / SCALE - 0.5
    i0 = torch.floor(c)
    f = c - i0
    rows = x.long()
    r = torch.zeros((n_out, n_in), dtype=F32, device=device)
    r.index_put_((rows, i0.clamp(0, n_in - 1).long()), (1.0 - f).to(F32),
                 accumulate=True)
    r.index_put_((rows, (i0 + 1).clamp(0, n_in - 1).long()), f.to(F32),
                 accumulate=True)
    return r


def tails(out: torch.Tensor, prev: torch.Tensor, curr: torch.Tensor, ts,
          q) -> list:
    """The in-between frame, planar f32, at each t in ``ts``."""
    hq, wq = out.shape[1:]
    nh, nw = hq // 4, wq // 4
    ry = out[:, 1::4][:, :nh] * 0.375 + out[:, 2::4][:, :nh] * 0.625
    lat = (ry[:, :, 1::4][:, :, :nw] * 0.375
           + ry[:, :, 2::4][:, :, :nw] * 0.625)
    r = _band_mat(hq * SCALE, hq, out.device)
    c = _band_mat(wq * SCALE, wq, out.device)
    mask = torch.sigmoid(torch.matmul(torch.matmul(r, out[4]), c.T))[None]
    fused = []
    for t in ts:
        fp = lat[0:2] * float(np.float32(SCALE * 2.0 * float(t)))
        fc = lat[2:4] * float(np.float32(SCALE * 2.0 * (1.0 - float(t))))
        wp = warp_single(prev, fp, TAIL_BLOCK, TAIL_RADIUS, q)
        wc = warp_single(curr, fc, TAIL_BLOCK, TAIL_RADIUS, q)
        tt = float(np.float32(t))
        w_p = mask * (1.0 - tt)
        w_c = (1.0 - mask) * tt
        fused.append((wp * w_p + wc * w_c) / (w_p + w_c + 1e-6))
    return fused
