"""The check that decides ``correct``, driven through a whole run of the
harness on the CPU at a small size (past the look for a card): the port's
plain path passes; the control (the reference one precision down, float8
e4m3) and each fault a cell can have fail.  A cell has no batch to halve
and no exchange between chips, so those faults do not apply."""

import copy

import pytest
import torch

from fgbench import control, harness, spec

CPU = torch.device("cpu")
SMALL = {"c4-1080p-4k": (128, 192, 256, 384),
         "c5-4k-learned": (64, 128, 64, 128)}
SEED = 2 ** 31 + 977


# mixes no cell of BENCHMARK.json runs now, kept for the cells that
# PERF.md lists for later: their check is held here all the same
LATER = {"c5-4k-learned.transcode": ("c5-4k-learned", "transcode-y4m420")}


def load(workload: str):
    if workload not in LATER:
        return spec.load_cell(workload)
    config, traffic = LATER[workload]
    return spec.Cell(
        name=workload, chips=1,
        config=spec._load_json(f"{spec.HERE}/configs/{config}.json"),
        traffic=spec._load_json(f"{spec.HERE}/traffic/{traffic}.json"),
        end_to_end=[], per_layer=[])


def small_cell(workload: str):
    cell = load(workload)
    cell.config = copy.deepcopy(cell.config)
    h, w, oh, ow = SMALL[cell.config["name"]]
    cell.config["engine"].update(input_height=h, input_width=w,
                                 output_height=oh, output_width=ow)
    cell.traffic = dict(cell.traffic, bank_frames=8, max_speed=2)
    return cell


def run(workload, seconds=0.5):
    return harness.run_cell(small_cell(workload), SEED, seconds, False, CPU)


@pytest.mark.parametrize("workload", [
    "c4-1080p-4k.live30", "c5-4k-learned.live30",
    "c5-4k-learned.transcode"])
def test_the_program_passes(workload):
    out = run(workload)
    assert out["correct"], out["check"]
    assert out["check"]["bad_byte_share"]["value"] == 0.0
    assert out["info"]["max_code_gap"] == 0      # the same plain arithmetic
    assert out["info"]["frames_compared"] >= 13
    assert out["failed"] == 0 and out["attempted"] > 13
    assert set(out["metrics"]) == {
        m["name"] for m, _ in load(workload).end_to_end}


@pytest.mark.parametrize("workload", ["c4-1080p-4k.live30",
                                      "c5-4k-learned.transcode"])
def test_the_control_fails(workload):
    cell = small_cell(workload)
    nums = control.control_numbers(cell, SEED, CPU, "fp8", span=60)
    limit = cell.config["limits"]["bad_byte_share"]
    assert nums["bad_byte_share"] > 3 * limit
    same = control.control_numbers(cell, SEED, CPU, "bf16", span=60)
    assert same["bad_byte_share"] == 0.0


def _wrap_step(monkeypatch, wrap):
    from tpufg_torch.engine import runner
    make = runner.make_interp_step

    def patched(*args, **kwargs):
        return wrap(make(*args, **kwargs), kwargs)

    monkeypatch.setattr(runner, "make_interp_step", patched)


@pytest.mark.parametrize("workload", ["c4-1080p-4k.live30",
                                      "c5-4k-learned.transcode"])
def test_an_answer_altered_where_it_is_made_fails(monkeypatch, workload):
    # the in-between frame replaced by curr: a repeated frame where an
    # interpolated one is due
    def wrap(step, kwargs):
        def altered(*args):
            outs = list(step(*args))
            n = len(outs) - (1 if kwargs.get("q_feed") else 0)
            outs[0] = outs[n - 1]
            return tuple(outs)
        return altered

    _wrap_step(monkeypatch, wrap)
    out = run(workload)
    assert not out["correct"]
    assert out["check"]["bad_byte_share"]["value"] > 0.05


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    # the learned step hands back the stream cache it was given, so every
    # pair reads the first frame's encoder features for prev
    def wrap(step, kwargs):
        if not kwargs.get("q_feed"):
            return step

        def stale(prev, curr, q_seed):
            return tuple(step(prev, curr, q_seed)[:-1]) + (q_seed,)
        return stale

    _wrap_step(monkeypatch, wrap)
    out = run("c5-4k-learned.transcode")
    assert not out["correct"]


def test_a_lost_frame_fails(monkeypatch):
    # one in-between frame of the window never reaches the sink (the
    # warm-up's frames make the first warm - 1 calls)
    warm = spec.load_cell("c4-1080p-4k.live30").traffic["warm_frames"]

    def wrap(step, kwargs):
        calls = []

        def lossy(*args):
            outs = tuple(step(*args))
            calls.append(1)
            return outs[1:] if len(calls) == warm + 5 else outs
        return lossy

    _wrap_step(monkeypatch, wrap)
    out = run("c4-1080p-4k.live30")
    assert not out["correct"]
    assert out["check"]["missing_frames"]["value"] >= 1


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.load_cell("c4-1080p-4k.live30")
    nums = control.control_numbers(cell, SEED, torch.device("cuda", 0))
    assert nums["bad_byte_share"] > cell.config["limits"]["bad_byte_share"]
