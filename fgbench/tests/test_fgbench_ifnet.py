"""The IFNet cell's readers on canned profiler traces (each reads what a
traced window of the network recorded, and returns None where its spans
or records are absent, as in a trace of a program without the network),
its operation and byte counts, and its reference's protocol and imports."""

import ast
import json
import os

import pytest
import torch

from fgbench import counts, counts_ifnet, spec, trace
from fgbench.spec import ROOT, reader

US = 1e-6
C6 = json.load(open(os.path.join(ROOT, "fgbench", "configs",
                                 "c6-4k-rife-ifnet.json")))["engine"]
NEW = ("ifnet_enqueue_ms", "refine_enqueue_ms", "ifnet_step_mfu",
       "ifnet_kernels_per_pair", "bias_prelu_roofline", "warp_grid_roofline",
       "pack_nhwc_roofline", "ifnet_merge_roofline", "ifnet_accum_roofline")


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def canned(spans=True, kernels=True, engine=C6):
    ev = [X("user_annotation", "fgbench.window", 0, 100000)]
    for k in range(2):          # two pairs, 40 ms apart
        t0 = 1000 + 40000 * k
        if spans:
            ev += [X("user_annotation", "tpufg.step.ifnet", t0, 3000),
                   X("user_annotation", "tpufg.step.context", t0 + 3000,
                     500),
                   X("user_annotation", "tpufg.step.refine", t0 + 3500,
                     1500)]
        if kernels:
            ev += [X("kernel", "(anonymous namespace)::bias_prelu_vec8(x)",
                     t0 + 100, 600),
                   X("kernel", "(anonymous namespace)::warp_planar_f32(x)",
                     t0 + 800, 500),
                   X("kernel", "(anonymous namespace)::warp_nhwc_bf16(x)",
                     t0 + 1400, 300),
                   X("kernel", "(anonymous namespace)::pack_nhwc_kernel(x)",
                     t0 + 1800, 400),
                   X("kernel", "(anonymous namespace)::ifnet_merge_kernel(x)",
                     t0 + 2300, 200),
                   X("kernel", "(anonymous namespace)::ifnet_accum_kernel(x)",
                     t0 + 2600, 300),
                   X("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", t0 + 3000,
                     4000)]
    t = trace.parse(ev)
    t.frames_in = 3
    t.cell = {"engine": engine, "root": ROOT,
              "checkpoint": "checkpoints/rife_ifnet_seed.json"}
    return t


def read(name, t):
    return reader("metrics", name)(t)


def test_the_readers_read_the_network():
    t = canned()
    assert read("ifnet_enqueue_ms", t) == pytest.approx(3.0)
    # context and refine together, a pair
    assert read("refine_enqueue_ms", t) == pytest.approx(2.0)
    assert read("ifnet_kernels_per_pair", t) == 7
    busy = 2 * 6300 * US
    h, w = counts_ifnet.padded(2160, 3840, 0.5)
    assert read("ifnet_step_mfu", t) == pytest.approx(
        100 * 2 * counts_ifnet.pair_flops(h, w, 0.5) / (busy * 989e12))
    nbytes = {k: b for k, (_, b) in counts_ifnet.kernel_bytes(C6).items()}
    for kernel, us in (("bias_prelu", 600), ("warp_grid", 800),
                       ("pack_nhwc", 400), ("ifnet_merge", 200),
                       ("ifnet_accum", 300)):
        assert read(f"{kernel}_roofline", t) == pytest.approx(
            100 * 2 * nbytes[kernel] / 3.35e12 / (2 * us * US)), kernel


@pytest.mark.parametrize("spans,kernels", [(False, True), (True, False),
                                           (False, False)])
def test_absent_spans_or_records_give_nothing(spans, kernels):
    t = canned(spans, kernels)
    silent = {n for n in NEW if read(n, t) is None}
    if not spans:
        assert silent == set(NEW)       # the parent's program: no network
    else:
        assert silent == set(NEW) - {"ifnet_enqueue_ms", "refine_enqueue_ms"}


def test_a_cell_without_the_scale_gives_nothing():
    engine = {k: v for k, v in C6.items() if k != "learned_scale"}
    t = canned(engine=engine)
    for name in ("ifnet_step_mfu", "bias_prelu_roofline"):
        assert read(name, t) is None


def test_the_kernels_bytes_and_bounds():
    h, w = counts_ifnet.padded(2160, 3840, 0.5)
    kb = {k: b for k, (_, b) in counts_ifnet.kernel_bytes(C6).items()}
    # the merge reads 2 x 4 + 1 f32 and 3 bf16 and writes 4 f32 a pixel
    assert kb["ifnet_merge"] == 2160 * 3840 * (13 * 4 + 3 * 2)
    assert kb["pack_nhwc"] == 6 * (6 * 272 * 480 + 17 * 544 * 960
                                   + 17 * 1088 * 1920 + 20 * h * w)
    # the bias and PReLU pass: the published widths' PReLU outputs, 4 bytes
    # an element and 2 more for a second destination
    assert kb["bias_prelu"] == 3_559_326_720
    assert all(counts.bound_s(b) > 0 for b in kb.values())


def test_the_reference_protocol_and_imports():
    conf = json.load(open(os.path.join(ROOT, "fgbench", "configs",
                                       "c6-4k-rife-ifnet.json")))
    small = dict(conf, engine=dict(conf["engine"], input_width=96,
                                   input_height=64, output_width=96,
                                   output_height=64))
    ref = spec.reference(conf)(small, "bf16", torch.device("cpu"), ROOT)
    frame = torch.randint(0, 256, (64, 96, 4), dtype=torch.uint8)
    assert torch.equal(ref.first(frame)[0], frame)
    mid, curr = ref.pair(frame, frame.flip(1))
    assert mid.shape == (64, 96, 4) and mid.dtype == torch.uint8
    assert torch.equal(curr, frame.flip(1))
    path = os.path.join(ROOT, "fgbench", "reference", "rife_ifnet.py")
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "json", "os", "numpy", "torch", "fgbench"}
    with pytest.raises(ValueError, match="midpoint"):
        spec.reference(conf)(dict(small, engine=dict(
            small["engine"], fps_multiplier=3)), "bf16", torch.device("cpu"),
            ROOT)
