"""The reference of configurations that take RAFT's optical flow (Teed &
Deng, arXiv:2003.12039, github.com/princeton-vl/RAFT ``core/raft.py``,
``update.py``, ``extractor.py``, ``corr.py``, ``utils/utils.py``) as their
learned motion: what each timed step should hand to the sink, from the
frames and the weights file alone.

``make(config, precision, device, root)`` returns a :class:`Reference`
(``first``, ``pair``, ``wire``; ``fgbench/reference/``'s protocol).  The
configuration's ``engine`` gives the sizes and the blend factors;
``checkpoint`` the weights, read here by this module's own reader: a
seeded recipe (``.json``: NumPy's PCG64 from ``seed``, each conv weight
``standard_normal * std`` in the published modules' order, He-normal for
ReLU ``sqrt(2 / fan_in)`` or ``gain / sqrt(fan_in)`` for the gained
layers, conv biases ``init.bias``, batch norms weight 1, bias 0, running
mean 0, running variance 1), an ``.npz`` of the published state-dict keys,
or a published ``.pth`` / ``.pt`` state dict (a ``module.`` prefix
stripped, ``num_batches_tracked`` and the ``norm3`` aliases of
``downsample.1`` dropped).

The network as the published code computes it, 12 updates, in f32 with
TF32 off, except that a value is rounded to the compute type
(``precision``, :func:`frames.rounder`) wherever the program stores it in
bf16: every conv's weight, bias and input; its output, then that plus its
bias; the normalised values of the instance and batch norms (their
statistics f32; the batch norm as its per-channel scale and shift); the
residual sums; the features; the lookup's samples; the flow as the
motion encoder reads it.  The correlation volume and its pyramid, the
hidden state, the gates, the coordinates, the flows, the softmax, the
upsampling and the warps stay f32.  The mask and the convex upsampling are
computed once, after the last update (the published code computes them at
every update and keeps the last).

Frames: RGB in [0, 1] (``byte * fl(1/255)``), ``2 x - 1``, padded as
``InputPadder`` pads (replicate to a multiple of 8, split between the
sides); the flow F from prev to curr is cut back; each in-between frame at
t is ``(1 - t) W(prev, -t F) + t W(curr, (1 - t) F)`` on all four channels,
W warplayer's warp (``grid_sample``, bilinear, border,
``align_corners=True``), stored as UNORM8 after the Lanczos resample to the
output size.  curr follows (passed through at identity size).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from fgbench.reference import frames, head

F32 = torch.float32
ITERS = 12
EPS = 1e-5
WEIGHT_SUFFIXES = (".json", ".npz", ".pth", ".pt")
_BN = ("weight", "bias", "running_mean", "running_var")


def keys() -> dict:
    """{state-dict key: shape} of the published model, in module order,
    without ``num_batches_tracked`` and the ``norm3`` aliases."""
    out = {}

    def conv(k, co, ci, kh, kw):
        out[f"{k}.weight"] = (co, ci, kh, kw)
        out[f"{k}.bias"] = (co,)

    def encoder(pre, batch):
        def norm(k, c):
            if batch:
                for leaf in _BN:
                    out[f"{k}.{leaf}"] = (c,)
        norm(f"{pre}.norm1", 64)
        conv(f"{pre}.conv1", 64, 3, 7, 7)
        cin = 64
        for name, dim, stride in (("layer1", 64, 1), ("layer2", 96, 2),
                                  ("layer3", 128, 2)):
            for i, (a, s) in enumerate(((cin, stride), (dim, 1))):
                k = f"{pre}.{name}.{i}"
                conv(f"{k}.conv1", dim, a, 3, 3)
                conv(f"{k}.conv2", dim, dim, 3, 3)
                norm(f"{k}.norm1", dim)
                norm(f"{k}.norm2", dim)
                if s != 1:
                    conv(f"{k}.downsample.0", dim, a, 1, 1)
                    norm(f"{k}.downsample.1", dim)
            cin = dim
        conv(f"{pre}.conv2", 256, 128, 1, 1)

    encoder("fnet", False)
    encoder("cnet", True)
    u = "update_block"
    conv(f"{u}.encoder.convc1", 256, 324, 1, 1)
    conv(f"{u}.encoder.convc2", 192, 256, 3, 3)
    conv(f"{u}.encoder.convf1", 128, 2, 7, 7)
    conv(f"{u}.encoder.convf2", 64, 128, 3, 3)
    conv(f"{u}.encoder.conv", 126, 256, 3, 3)
    for half, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for g in "zrq":
            conv(f"{u}.gru.conv{g}{half}", 128, 384, kh, kw)
    conv(f"{u}.flow_head.conv1", 256, 128, 3, 3)
    conv(f"{u}.flow_head.conv2", 2, 256, 3, 3)
    conv(f"{u}.mask.0", 256, 128, 3, 3)
    conv(f"{u}.mask.2", 576, 256, 1, 1)
    return out


def draw_recipe(recipe: dict) -> dict:
    """The weights of a seeded recipe, as :func:`keys` orders them."""
    init = recipe["init"]
    rng = np.random.default_rng(int(recipe["seed"]))
    norms = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
             "running_var": 1.0}
    out = {}
    for key, shape in keys().items():
        layer, leaf = key.rsplit(".", 1)
        if len(shape) == 4:
            fan = int(np.prod(shape[1:]))
            gain = init["gains"].get(layer)
            std = (np.sqrt(2.0 / fan) if gain is None
                   else float(gain) / np.sqrt(fan))
            out[key] = (rng.standard_normal(shape, dtype=np.float32)
                        * np.float32(std))
        elif ".norm" in key or "downsample.1" in key:
            out[key] = np.full(shape, norms[leaf], np.float32)
        else:
            out[key] = np.full(shape, float(init["bias"]), np.float32)
    return out


def read_weights(path: str) -> dict:
    """{key: float32 array} of any of the three forms, checked against
    :func:`keys`."""
    if path.endswith(".json"):
        with open(path) as f:
            recipe = json.load(f)
        if recipe.get("architecture") != "raft":
            raise ValueError(f"{path}: not a raft recipe")
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
        if k.endswith(".num_batches_tracked") or ".norm3." in k:
            continue
        if k not in want or v.shape != want[k] or v.dtype != np.float32:
            raise ValueError(f"{path}: {k} {v.dtype} {v.shape} does not fit")
        out[k] = v
    if set(out) != set(want):
        raise ValueError(f"{path}: missing {sorted(set(want) - set(out))}")
    return out


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """warplayer's backward warp of [n, C, h, w] by [n, 2, h, w]."""
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


class Reference:
    def __init__(self, engine: dict, precision: str, weights: dict,
                 device: torch.device):
        k = max(2, int(engine.get("fps_multiplier", 2)))
        self.factors = ([float(engine.get("interpolation_factor", 0.5))]
                        if k == 2 else [i / float(k) for i in range(1, k)])
        self.e = engine
        self.q = frames.rounder(precision)
        self.w = {}
        for key, v in weights.items():
            t = torch.as_tensor(v, device=device)
            self.w[key] = t if ".norm" in key or "downsample.1" in key \
                else self.q(t)
        self.out_hw = (engine["output_height"], engine["output_width"])
        self.identity = self.out_hw == (engine["input_height"],
                                        engine["input_width"])

    # ------------------------------------------------------------- layers

    def _conv(self, x, key, stride=1):
        wt = self.w[f"{key}.weight"]
        kh, kw = wt.shape[2:]
        y = self.q(F.conv2d(self.q(x), wt, None, stride, (kh // 2, kw // 2)))
        return self.q(y + self.w[f"{key}.bias"][None, :, None, None])

    def _norm(self, key, y):
        if key.startswith("fnet"):
            var, mean = torch.var_mean(y, (2, 3), correction=0, keepdim=True)
            return self.q((y - mean) * torch.rsqrt(var + EPS))
        wt, b = self.w[f"{key}.weight"], self.w[f"{key}.bias"]
        scale = wt / torch.sqrt(self.w[f"{key}.running_var"] + EPS)
        shift = b - self.w[f"{key}.running_mean"] * scale
        return self.q(y * scale[None, :, None, None]
                      + shift[None, :, None, None])

    def _encoder(self, pre, x):
        y = torch.relu(self._norm(f"{pre}.norm1",
                                  self._conv(x, f"{pre}.conv1", 2)))
        for name, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
            for i, s in enumerate((stride, 1)):
                k = f"{pre}.{name}.{i}"
                z = torch.relu(self._norm(f"{k}.norm1",
                                          self._conv(y, f"{k}.conv1", s)))
                z = torch.relu(self._norm(f"{k}.norm2",
                                          self._conv(z, f"{k}.conv2")))
                if s != 1:
                    y = self._norm(f"{k}.downsample.1",
                                   self._conv(y, f"{k}.downsample.0", s))
                y = torch.relu(self.q(y + z))
        return self._conv(y, f"{pre}.conv2")

    @staticmethod
    def _sampler(img, coords):
        h, w = img.shape[-2:]
        xgrid, ygrid = coords.split([1, 1], dim=-1)
        xgrid = 2 * xgrid / (w - 1) - 1
        ygrid = 2 * ygrid / (h - 1) - 1
        grid = torch.cat([xgrid, ygrid], dim=-1)
        return F.grid_sample(img, grid, align_corners=True)

    def _lookup(self, pyramid, coords):
        r = 4
        c = coords.permute(0, 2, 3, 1)
        b, h, w, _ = c.shape
        d = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
        out = []
        for i, corr in enumerate(pyramid):
            centroid = c.reshape(b * h * w, 1, 1, 2) / 2 ** i
            lvl = centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
            out.append(self._sampler(corr, lvl).view(b, h, w, -1))
        return self.q(torch.cat(out, dim=-1).permute(0, 3, 1, 2))

    def _gru(self, h, x, half):
        u = "update_block.gru"
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self._conv(hx, f"{u}.convz{half}"))
        r = torch.sigmoid(self._conv(hx, f"{u}.convr{half}"))
        q = torch.tanh(self._conv(torch.cat([r * h, x], dim=1),
                                  f"{u}.convq{half}"))
        return (1 - z) * h + z * q

    def _upsample(self, flow, mask):
        n, _, h, w = flow.shape
        mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
        up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
        up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(n, 2, 8 * h, 8 * w)

    # -------------------------------------------------------------- model

    def flow(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """RGB f32 [1, 3, H, W] frames in [0, 1], padded -> the flow from
        the first to the second, f32 [1, 2, H, W]."""
        u = "update_block"
        x0, x1 = 2 * img0 - 1, 2 * img1 - 1
        fmap1 = self._encoder("fnet", x0)
        fmap2 = self._encoder("fnet", x1)
        cnet = self._encoder("cnet", x0)
        net, inp = torch.tanh(cnet[:, :128]), torch.relu(cnet[:, 128:])
        _, dim, h, w = fmap1.shape
        corr = torch.matmul(fmap1.view(1, dim, h * w).transpose(1, 2),
                            fmap2.view(1, dim, h * w))
        corr = corr.view(h * w, 1, h, w) / torch.sqrt(
            torch.tensor(dim).float())
        pyramid = [corr]
        for _ in range(3):
            pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
        ys, xs = torch.meshgrid(torch.arange(h, device=img0.device),
                                torch.arange(w, device=img0.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys])[None].float()
        coords1 = coords0.clone()
        for _ in range(ITERS):
            corr = self._lookup(pyramid, coords1)
            flow = coords1 - coords0
            e = f"{u}.encoder"
            cor = torch.relu(self._conv(corr, f"{e}.convc1"))
            cor = torch.relu(self._conv(cor, f"{e}.convc2"))
            flo = torch.relu(self._conv(flow, f"{e}.convf1"))
            flo = torch.relu(self._conv(flo, f"{e}.convf2"))
            out = torch.relu(self._conv(torch.cat([cor, flo], dim=1),
                                        f"{e}.conv"))
            motion = torch.cat([out, self.q(flow)], dim=1)
            x = torch.cat([inp, motion], dim=1)
            net = self._gru(net, x, "1")
            net = self._gru(net, x, "2")
            delta = self._conv(torch.relu(self._conv(
                net, f"{u}.flow_head.conv1")), f"{u}.flow_head.conv2")
            coords1 = coords1 + delta
        mask = 0.25 * self._conv(torch.relu(self._conv(
            net, f"{u}.mask.0")), f"{u}.mask.2")
        return self._upsample(coords1 - coords0, mask)

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
            ph, pw = (-h) % 8, (-w) % 8
            pad = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)

            def padded(x):
                return F.pad(x[None, :3], pad, mode="replicate")

            fl = self.flow(padded(p), padded(c))[
                0, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w]
            pair = torch.stack([p, c])
            outs = []
            for t in self.factors:
                wp = warp(pair, torch.stack([fl * -t, fl * (1.0 - t)]))
                outs.append(self._out(wp[0] * (1.0 - t) + wp[1] * t))
            last = frames.to_u8(curr) if self.identity else self._out(c)
            return outs + [last]

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
        raise ValueError(f"{path}: not a RAFT weights file")
    return Reference(config["engine"], precision, read_weights(path),
                     torch.device(device))
