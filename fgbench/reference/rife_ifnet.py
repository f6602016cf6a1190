"""The reference of configurations that run RIFE's own network (IFNet,
Contextnet and U-Net; Huang et al., arXiv:2011.06294,
github.com/hzwer/ECCV2022-RIFE ``model/IFNet.py``, ``model/refine.py``,
``model/warplayer.py``, ``inference_video.py``) as the learned head: what
each timed step should hand to the sink, from the frames and the weights
file alone.

``make(config, precision, device, root)`` returns a :class:`Reference`
(``first``, ``pair``, ``wire``; ``fgbench/reference/``'s protocol).  The
configuration's ``engine`` gives the sizes and ``learned_scale`` (RIFE's
``--scale`` s: the IFBlocks run at 4/s, 2/s, 1/s); ``checkpoint`` the
weights, read here by this module's own reader: a seeded recipe
(``.json``: NumPy's PCG64 from ``seed``, He-normal for PReLU(a) with
``std = sqrt(2 / ((1 + a^2) fan_in))``, ``gain / sqrt(fan_in)`` for the
gained layers, biases 0, slopes a; a 3x3 conv's fan-in is ``in * 9``, a
stride-2 4x4 transposed conv's ``in * 4``), an ``.npz`` of the published
state-dict keys, or a published ``.pkl`` / ``.pth`` / ``.pt`` state dict
(a ``module.`` prefix stripped, the teacher's ``block_tea.*`` dropped).

The network as the published code computes it, in f32 with cuDNN's TF32
off, except that a value is rounded to the compute type (``precision``,
:func:`frames.rounder`) wherever the program stores it in bf16: every
weight, bias and PReLU slope; a conv's or transposed conv's input; its
output, then that plus its bias, then the PReLU's output; the IFBlock's
residual sum; the Contextnet's features and their warps (the warp itself
in f32).  The flows and masks, their resizes, the sampling grids, the
warps of the frames, the final sigmoid, merge and clamp stay f32.

Frames: zero-padded right and bottom to a multiple of ``max(32, 32 /
s)``, RGB in [0, 1] (``byte * fl(1/255)``); the alpha channel is warped
by the final flows and merged by the final mask, with no residual, and
padded with its last row and column (not zeros: a constant alpha stays
constant where a flow reaches into the pad); the midpoint is cropped back and stored as UNORM8 (Lanczos to the output
size first where it differs from the input).  curr follows it (passed
through at identity size).  The fps multiplier must be 2 at t = 0.5:
the published network predicts the midpoint only.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from fgbench.reference import frames, head

F32 = torch.float32
WEIGHT_SUFFIXES = (".json", ".npz", ".pkl", ".pth", ".pt")

# the published modules: (prefix, kind, in, out), kind "c" a 3x3 conv +
# PReLU, "c2" a Conv2 (a stride-2 "c", then a stride-1 "c"), "t" a stride-2
# 4x4 transposed conv + PReLU, "T" the same without PReLU, "p" a plain
# 3x3 conv
def _modules() -> list:
    out = []
    for name, cin, c in (("block0", 6, 240), ("block1", 17, 150),
                         ("block2", 17, 90)):
        out += [(f"{name}.conv0.0", "c", cin, c // 2),
                (f"{name}.conv0.1", "c", c // 2, c)]
        out += [(f"{name}.convblock.{i}", "c", c, c) for i in range(8)]
        out.append((f"{name}.lastconv", "T", c, 5))
    out += [(f"contextnet.conv{k + 1}", "c2", cin, cout) for k, (cin, cout)
            in enumerate(((3, 16), (16, 32), (32, 64), (64, 128)))]
    out += [("unet.down0", "c2", 17, 32), ("unet.down1", "c2", 64, 64),
            ("unet.down2", "c2", 128, 128), ("unet.down3", "c2", 256, 256),
            ("unet.up0", "t", 512, 128), ("unet.up1", "t", 256, 64),
            ("unet.up2", "t", 128, 32), ("unet.up3", "t", 64, 16),
            ("unet.conv", "p", 16, 3)]
    return out


def keys() -> dict:
    """{state-dict key: (shape, what)} of the published network without
    its teacher, in module order; ``what`` is ``("w", fan_in, prelu)``
    for a weight, ``"b"`` a bias, ``"a"`` a PReLU slope."""
    out = {}

    def conv(prefix, cin, cout, act):
        sub = f"{prefix}.0" if act else prefix
        out[f"{sub}.weight"] = ((cout, cin, 3, 3), ("w", cin * 9, act))
        out[f"{sub}.bias"] = ((cout,), "b")
        if act:
            out[f"{prefix}.1.weight"] = ((cout,), "a")

    for prefix, kind, cin, cout in _modules():
        if kind == "c":
            conv(prefix, cin, cout, True)
        elif kind == "c2":
            conv(f"{prefix}.conv1", cin, cout, True)
            conv(f"{prefix}.conv2", cout, cout, True)
        elif kind == "p":
            conv(prefix, cin, cout, False)
        else:
            sub = f"{prefix}.0" if kind == "t" else prefix
            out[f"{sub}.weight"] = ((cin, cout, 4, 4),
                                    ("w", cin * 4, kind == "t"))
            out[f"{sub}.bias"] = ((cout,), "b")
            if kind == "t":
                out[f"{prefix}.1.weight"] = ((cout,), "a")
    return out


def draw_recipe(recipe: dict) -> dict:
    """The weights of a seeded recipe, as :func:`keys` orders them."""
    init = recipe["init"]
    a = float(init["prelu"])
    rng = np.random.default_rng(int(recipe["seed"]))
    out = {}
    for key, (shape, what) in keys().items():
        if what == "b":
            out[key] = np.full(shape, float(init["bias"]), np.float32)
        elif what == "a":
            out[key] = np.full(shape, a, np.float32)
        else:
            _, fan, act = what
            layer = key[:-len(".weight")]
            gain = init["gains"].get(layer)
            if gain is None and not act:
                raise ValueError(f"recipe: no gain for {layer}")
            std = (np.sqrt(2.0 / ((1.0 + a * a) * fan)) if gain is None
                   else float(gain) / np.sqrt(fan))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
    return out


def read_weights(path: str) -> dict:
    """{key: float32 array} of any of the three forms, checked against
    :func:`keys`."""
    if path.endswith(".json"):
        with open(path) as f:
            recipe = json.load(f)
        if recipe.get("architecture") != "rife_ifnet":
            raise ValueError(f"{path}: not a rife_ifnet recipe")
        return draw_recipe(recipe)
    if path.endswith(".npz"):
        with np.load(path) as data:
            raw = {k: np.asarray(data[k]) for k in data.files}
    else:
        raw = {k: v.numpy() for k, v in torch.load(
            path, map_location="cpu", weights_only=True).items()}
    want = keys()
    out = {}
    for k, v in raw.items():
        k = k[7:] if k.startswith("module.") else k
        if k.startswith("block_tea."):
            continue
        if k not in want or v.shape != want[k][0] or v.dtype != np.float32:
            raise ValueError(f"{path}: {k} {v.dtype} {v.shape} does not fit")
        out[k] = v
    if set(out) != set(want):
        raise ValueError(f"{path}: missing {sorted(set(want) - set(out))}")
    return out


class Reference:
    def __init__(self, engine: dict, precision: str, weights: dict,
                 device: torch.device):
        if int(engine.get("fps_multiplier", 2)) != 2 or float(
                engine.get("interpolation_factor", 0.5)) != 0.5:
            raise ValueError("the IFNet predicts the midpoint of a pair only")
        self.e = engine
        self.q = frames.rounder(precision)
        self.s = float(engine.get("learned_scale", 1.0))
        self.w = {k: self.q(torch.as_tensor(v, device=device))
                  for k, v in weights.items()}
        self.out_hw = (engine["output_height"], engine["output_width"])
        self.identity = self.out_hw == (engine["input_height"],
                                        engine["input_width"])

    # ------------------------------------------------------------- layers

    def _act(self, y: torch.Tensor, key: str) -> torch.Tensor:
        a = self.w[key][None, :, None, None]
        return self.q(torch.where(y > 0, y, a * y))

    def _conv(self, x, prefix, stride=1, act=True):
        sub = f"{prefix}.0" if act else prefix
        y = self.q(F.conv2d(self.q(x), self.w[f"{sub}.weight"], None,
                            stride, 1))
        y = self.q(y + self.w[f"{sub}.bias"][None, :, None, None])
        return self._act(y, f"{prefix}.1.weight") if act else y

    def _conv2(self, x, prefix):
        return self._conv(self._conv(x, f"{prefix}.conv1", 2),
                          f"{prefix}.conv2")

    def _tconv(self, x, prefix, act=True):
        sub = f"{prefix}.0" if act else prefix
        y = self.q(F.conv_transpose2d(self.q(x), self.w[f"{sub}.weight"],
                                      None, 2, 1))
        y = self.q(y + self.w[f"{sub}.bias"][None, :, None, None])
        return self._act(y, f"{prefix}.1.weight") if act else y

    @staticmethod
    def _interp(x, factor):
        return F.interpolate(x, scale_factor=factor, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def _warp(x, flow):
        n, _, h, w = flow.shape
        gx = torch.linspace(-1.0, 1.0, w, device=flow.device).view(
            1, 1, 1, w).expand(n, -1, h, -1)
        gy = torch.linspace(-1.0, 1.0, h, device=flow.device).view(
            1, 1, h, 1).expand(n, -1, -1, w)
        flow = torch.cat([flow[:, 0:1] / ((x.shape[3] - 1.0) / 2.0),
                          flow[:, 1:2] / ((x.shape[2] - 1.0) / 2.0)], 1)
        g = (torch.cat([gx, gy], 1) + flow).permute(0, 2, 3, 1)
        return F.grid_sample(x, g, mode="bilinear", padding_mode="border",
                             align_corners=True)

    def _block(self, name, x, flow, scale):
        if scale != 1:
            x = self._interp(x, 1.0 / scale)
        if flow is not None:
            x = torch.cat((x, self._interp(flow, 1.0 / scale) * 1.0 / scale),
                          1)
        x = self._conv(self._conv(x, f"{name}.conv0.0", 2),
                       f"{name}.conv0.1", 2)
        y = x
        for i in range(8):
            y = self._conv(y, f"{name}.convblock.{i}")
        x = self.q(y + x)
        t = self._interp(self._tconv(x, f"{name}.lastconv", act=False),
                         scale * 2)
        return t[:, :4] * scale * 2, t[:, 4:5]

    def _context(self, img, flow):
        x, out = img, []
        for k in range(4):
            x = self._conv2(x, f"contextnet.conv{k + 1}")
            flow = self._interp(flow, 0.5) * 0.5
            out.append(self.q(self._warp(x, flow)))
        return out

    # -------------------------------------------------------------- model

    def midpoint(self, img0: torch.Tensor, img1: torch.Tensor):
        """Padded f32 RGBA [1, 4, H, W] frames -> the merged midpoint."""
        i0, i1 = img0[:, :3], img1[:, :3]
        scales = [4.0 / self.s, 2.0 / self.s, 1.0 / self.s]
        flow, mask = self._block("block0", torch.cat((i0, i1), 1), None,
                                 scales[0])
        w0, w1 = self._warp(i0, flow[:, :2]), self._warp(i1, flow[:, 2:4])
        for name, s in (("block1", scales[1]), ("block2", scales[2])):
            fd, md = self._block(name, torch.cat((i0, i1, w0, w1, mask), 1),
                                 flow, s)
            flow, mask = flow + fd, mask + md
            last = name == "block2"
            w0 = self._warp(img0 if last else i0, flow[:, :2])
            w1 = self._warp(img1 if last else i1, flow[:, 2:4])
        c0 = self._context(i0, flow[:, :2])
        c1 = self._context(i1, flow[:, 2:4])
        s0 = self._conv2(torch.cat((i0, i1, w0[:, :3], w1[:, :3], mask,
                                    flow), 1), "unet.down0")
        s1 = self._conv2(torch.cat((s0, c0[0], c1[0]), 1), "unet.down1")
        s2 = self._conv2(torch.cat((s1, c0[1], c1[1]), 1), "unet.down2")
        s3 = self._conv2(torch.cat((s2, c0[2], c1[2]), 1), "unet.down3")
        x = self._tconv(torch.cat((s3, c0[3], c1[3]), 1), "unet.up0")
        x = self._tconv(torch.cat((x, s2), 1), "unet.up1")
        x = self._tconv(torch.cat((x, s1), 1), "unet.up2")
        x = self._tconv(torch.cat((x, s0), 1), "unet.up3")
        u = torch.sigmoid(self._conv(x, "unet.conv", act=False))
        m = torch.sigmoid(mask)
        merged = w0 * m + w1 * (1 - m)
        res = torch.cat((u * 2 - 1, torch.zeros_like(u[:, :1])), 1)
        return torch.clamp(merged + res, 0, 1)

    # ------------------------------------------------------------ protocol

    def _out(self, planar: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return frames.store(planar)
        return frames.scale_store(planar, *self.out_hw,
                                  self.e.get("lanczos_a", 3))

    def first(self, frame: torch.Tensor) -> list:
        if self.identity:
            return [frames.to_u8(frame)]
        return [self._out(frames.unpack(frame))]

    def pair(self, prev: torch.Tensor, curr: torch.Tensor) -> list:
        with head.no_tf32():
            p, c = frames.unpack(prev), frames.unpack(curr)
            _, h, w = p.shape
            m = max(32, int(32 / self.s))
            hp, wp = -(-h // m) * m, -(-w // m) * m
            pad = (0, wp - w, 0, hp - h)

            def padded(x):
                return torch.cat([F.pad(x[None, :3], pad),
                                  F.pad(x[None, 3:], pad, mode="replicate")],
                                 1)

            mid = self.midpoint(padded(p), padded(c))
            mid = mid[0, :, :h, :w]
            last = frames.to_u8(curr) if self.identity else self._out(c)
            return [self._out(mid), last]

    @staticmethod
    def wire(out: torch.Tensor, sink_wire: str) -> torch.Tensor:
        if sink_wire == "rgba":
            return out
        return frames.y4m_payload(out, sink_wire[3:])


def make(config: dict, precision: str, device: torch.device,
         root: str = ".") -> Reference:
    """The reference of ``config`` in ``precision``; the checkpoint path
    is read relative to ``root``."""
    path = os.path.join(root, config["checkpoint"])
    if not path.endswith(WEIGHT_SUFFIXES):
        raise ValueError(f"{path}: not an IFNet weights file")
    return Reference(config["engine"], precision, read_weights(path),
                     torch.device(device))
