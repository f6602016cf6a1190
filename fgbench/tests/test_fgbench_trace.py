"""The per-layer arithmetic on a canned profiler trace: per-frame sums,
the union of device intervals and the idle share, rooflines and mfu from
shapes, and the breakdown."""

import pytest

from fgbench import counts, trace
from fgbench.spec import ROOT, reader

US = 1e-6


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


C4 = {"input_height": 1080, "input_width": 1920, "output_height": 2160,
      "output_width": 3840, "lanczos_a": 3}
C5 = {"input_height": 2160, "input_width": 3840, "output_height": 2160,
      "output_width": 3840}


def canned(engine=C4, checkpoint=None):
    ev = [
        X("user_annotation", "fgbench.window", 1000, 10000),
        X("user_annotation", "tpufg.step", 1000, 400),
        X("user_annotation", "tpufg.readback", 1400, 1600),
        X("user_annotation", "tpufg.step", 6000, 600),
        X("user_annotation", "tpufg.readback", 6600, 1400),
        X("user_annotation", "fgbench.source_wait", 3000, 3000),
        X("cpu_op", "aten::add", 1000, 10),
        X("kernel", "void (anonymous namespace)::lanczos_packed_tile_kernel"
          "<6>(float const*)", 1100, 40),
        X("kernel", "void (anonymous namespace)::lanczos_packed_tile_kernel"
          "<6>(float const*)", 6100, 60),
        X("kernel", "(anonymous namespace)::conv_chain_mma_kernel()", 1200,
          100),
        X("gpu_memset", "Memset (Device)", 1250, 100),      # overlaps
        X("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1500, 300),
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2000, 500),
        X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 6700, 500),
        X("kernel", "late", 11500, 100),                    # past the window
    ]
    t = trace.parse(ev)
    t.frames_in = 2
    t.cell = {"engine": engine, "root": ROOT, "checkpoint": checkpoint}
    return t


def read(name, t):
    return reader("metrics", name)(t)


def test_parse_sorts_records():
    t = canned()
    assert t.window == pytest.approx((1000 * US, 10000 * US))
    assert len(t.kernels()) == 4 and len(t.kernels("lanczos_packed")) == 2
    assert len(t.copies("HtoD")) == 1 and len(t.copies("DtoH")) == 2
    assert set(t.spans) == {"tpufg.step", "tpufg.readback",
                            "fgbench.source_wait"}


def test_busy_is_the_union_inside_the_window():
    t = canned()
    # 1100-1140, 1200-1350 (kernel and memset), 1500-1800, 2000-2500,
    # 6100-6160, 6700-7200; the kernel past the window left out
    flat = [x for iv in t.busy_intervals() for x in iv]
    assert flat == pytest.approx([x * US for x in (
        1100, 1140, 1200, 1350, 1500, 1800, 2000, 2500, 6100, 6160, 6700,
        7200)])
    assert t.busy_s() == pytest.approx(1550 * US)
    assert read("idle_pct", t) == pytest.approx(100 * (1 - 1550 / 10000))


def test_per_frame_sums():
    t = canned()
    assert read("readback_ms.live", t) == pytest.approx((1.6 + 1.4) / 2)
    assert read("readback_ms.transcode", t) == read("readback_ms.live", t)
    assert read("enqueue_ms", t) == pytest.approx((0.4 + 0.6) / 2)
    assert read("copy_ms.live", t) == pytest.approx((0.3 + 0.5 + 0.5) / 2)
    assert read("busy_ms", t) == pytest.approx((0.04 + 0.06 + 0.1 + 0.1)
                                               / 2)


def test_rooflines_from_shapes():
    t = canned()
    bound = counts.lanczos_packed_bytes(1080, 1920, 2160, 3840) / 3.35e12
    assert read("lanczos_packed_roofline", t) == pytest.approx(
        100 * bound / 50e-6)
    assert read("conv_chain_roofline", t) is None     # no head in config 4
    t5 = canned(C5, "checkpoints/head64_v4.npz")
    chain = counts.conv_chain_flops((17, 64, 64, 5), 540, 960) / 989e12
    assert read("conv_chain_roofline", t5) == pytest.approx(
        100 * chain / 100e-6)
    # a 4K pair's 85.5 GFLOP over the window's 0.3 ms of kernels (not its
    # 10 ms, most of it the source's wait) at 989 TFLOP/s
    busy = sum(d for _, _, d in t5.kernels())
    assert busy == pytest.approx(0.3e-3)
    assert read("step_mfu", t5) == pytest.approx(
        100 * 85_548_441_600 / (busy * 989e12))
    assert read("step_mfu", t) is None


def test_nothing_to_read_gives_nothing():
    t = trace.parse([X("user_annotation", "fgbench.window", 0, 1000)])
    t.frames_in = 3
    t.cell = {"engine": C4, "root": ROOT, "checkpoint": None}
    for name in ("copy_ms.live", "busy_ms", "idle_pct",
                 "lanczos_packed_roofline"):
        assert read(name, t) is None, name
    assert read("readback_ms.live", t) == 0.0


def test_breakdown_names_idle_gaps_by_the_host_span():
    b = trace.breakdown(canned())
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("Memcpy DtoH") and len(names) <= 10
    assert b["device_ops"][0][1] == pytest.approx(1000 * US)
    gaps = {n.split(" (")[0]: s for n, s in b["idle_gaps"]}
    # by each gap's middle: 2500-6100 in the source's wait (3000-6000),
    # 7200-11000 after the last span, 1000-1100, 1140-1200 and 6160-6700
    # in a step, 1350-1500 and 1800-2000 in the first readback
    assert gaps["fgbench.source_wait"] == pytest.approx(3600 * US)
    assert gaps["outside the named spans"] == pytest.approx(3800 * US)
    assert gaps["tpufg.step"] == pytest.approx((100 + 60 + 540) * US)
    assert gaps["tpufg.readback"] == pytest.approx((150 + 200) * US)
    assert sum(gaps.values()) == pytest.approx(10000 * US - 1550 * US)
