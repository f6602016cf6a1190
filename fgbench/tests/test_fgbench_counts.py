"""The yardstick's counts, each against the shapes it is derived from."""

import os

import pytest

from fgbench import counts
from fgbench.spec import ROOT

CKPT = os.path.join(ROOT, "checkpoints", "head64_v4.npz")


def test_lanczos_packed_bytes_1080p_to_4k():
    planes = 4 * 1080 * 1920 * 4          # four f32 planes in
    tables = (2160 + 3840) * 6 * (4 + 4)  # an int32 index, an f32 weight
    packed = 2160 * 3840 * 4              # one int32 a pixel out
    assert counts.lanczos_packed_bytes(1080, 1920, 2160, 3840) == (
        planes + tables + packed) == 66_643_200
    # bytes bound it: 66.6 MB at 3.35 TB/s
    assert counts.lanczos_packed_bound_s(1080, 1920, 2160, 3840) == (
        pytest.approx(66_643_200 / 3.35e12))
    assert counts.lanczos_packed_ops(1080, 2160, 3840) / 67e12 < (
        66_643_200 / 3.35e12)


def test_conv_chain_operations_at_a_quarter_of_4k():
    per_pixel = 9 * (17 * 64 + 64 * 64 + 64 * 5)   # multiply-adds
    flops = 2 * per_pixel * 540 * 960
    assert counts.conv_chain_flops((17, 64, 64, 5), 540, 960) == flops
    assert flops == 51_358_924_800
    assert counts.conv_chain_bound_s((17, 64, 64, 5), 540, 960) == (
        pytest.approx(flops / 989e12))


def test_head_multiply_adds_per_layer_at_4k():
    shapes = counts.checkpoint_shapes(CKPT)
    assert shapes == {"enc1": (32, 4), "enc2": (32, 32), "enc3": (64, 64),
                      "c_body": (64, 64), "c_head": (5, 64),
                      "r_in": (64, 17), "r_body": (64, 64),
                      "r_head": (5, 64)}
    macs = {  # 9 * c_in * c_out * output pixels
        "enc1": 9 * 4 * 32 * 1080 * 1920,     # stride 2 from 4K
        "enc2": 9 * 32 * 32 * 540 * 960,      # stride 2
        "enc3": 9 * 64 * 64 * 270 * 480,      # stride 2, both frames' 32
        "c_body": 9 * 64 * 64 * 270 * 480,
        "c_head": 9 * 64 * 5 * 270 * 480,
        "r_in": 9 * 17 * 64 * 540 * 960,
        "r_body": 9 * 64 * 64 * 540 * 960,
        "r_head": 9 * 64 * 5 * 540 * 960,
    }
    assert macs["enc1"] == 2_388_787_200 and macs["r_body"] == 19_110_297_600
    total = sum(macs.values())
    assert total == 42_774_220_800
    assert counts.head_pair_flops(shapes, 2160, 3840) == 2 * total
    # one layer at a time: the function counts each where it runs
    for name in shapes:
        assert counts.head_pair_flops({name: shapes[name]}, 2160, 3840) == (
            2 * macs[name])


def test_bound_takes_the_larger_term():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12, "f32") == pytest.approx(2.0)
