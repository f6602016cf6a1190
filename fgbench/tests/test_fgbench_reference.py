"""A configuration names the reference module that decides its ``correct``
(``"reference"`` in its file), and the benchmark finds it by name, as it
finds a metric's reader: a configuration that brings a reference of its
own adds files and edits none.  Whole runs of the harness on the CPU at
``test_fgbench_check.py``'s small sizes."""

import copy
import json
import os
import shutil
import sys

import pytest
import torch

from fgbench import control, harness, spec
from fgbench.reference import steps

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1213
SMALL = {"c4-1080p-4k": (128, 192, 256, 384),
         "c5-4k-learned": (64, 128, 64, 128)}
REFERENCE = "fgbench.reference."
COMPARED = ("frames_compared", "bytes_compared", "max_code_gap")

# today's answer in bf16 whatever the precision asked for, every byte as
# the sink takes it moved OFFSET codes towards the middle
SHIFTED = '''
import torch

from fgbench.reference import steps

OFFSET = {offset}


class Shifted:
    def __init__(self, inner):
        self.inner = inner
        self.first, self.pair = inner.first, inner.pair

    def wire(self, out, sink_wire):
        w = self.inner.wire(out, sink_wire).to(torch.int16)
        return torch.where(w < 128, w + OFFSET, w - OFFSET).to(torch.uint8)


def make(config, precision, device, root):
    return Shifted(steps.make(config, "bf16", device, root))
'''


def small(cell, reference=None):
    """``cell`` at its small size (a configuration the tests add has
    config 4's), naming ``reference`` if given."""
    cell = copy.copy(cell)
    cell.config = copy.deepcopy(cell.config)
    h, w, oh, ow = SMALL.get(cell.config["name"], SMALL["c4-1080p-4k"])
    cell.config["engine"].update(input_height=h, input_width=w,
                                 output_height=oh, output_width=ow)
    if reference is not None:
        cell.config["reference"] = reference
    cell.traffic = dict(cell.traffic, bank_frames=8, max_speed=2)
    return cell


def run(cell):
    return harness.run_cell(cell, SEED, 0.5, False, CPU)


def numbers(out):
    return ({k: r["value"] for k, r in out["check"].items()},
            {k: out["info"][k] for k in COMPARED})


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the benchmark, found in place of ``fgbench/``, to which
    ``add(name, reference, source)`` adds a configuration of config 4's
    settings naming ``reference``, the module file ``source`` (if given)
    and the cell ``<name>.live30``: files and entries, no edit.  Gives
    ``add``, which returns the cell as ``spec.load_cell`` finds it."""
    shutil.copytree(spec.HERE, tmp_path / "fgbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    c4 = json.load(open(os.path.join(spec.HERE, "configs",
                                     "c4-1080p-4k.json")))
    monkeypatch.setattr(spec, "HERE", str(tmp_path / "fgbench"))
    # the copy's reference modules replace the package's in sys.modules:
    # the package's come back afterwards, the copy's alone go
    before = {n for n in sys.modules if n.startswith(REFERENCE)}
    for name in before:
        monkeypatch.setitem(sys.modules, name, sys.modules[name])

    def add(name, reference, source=None):
        if source is not None:
            (tmp_path / "fgbench" / "reference" / f"{reference}.py"
             ).write_text(source)
        config = dict(c4, name=name, reference=reference)
        (tmp_path / "fgbench" / "configs" / f"{name}.json").write_text(
            json.dumps(config))
        bench["configs"].append({
            "name": name, "source": c4["source"],
            "file": f"fgbench/configs/{name}.json", "reduced": [],
            "why": "config 4 checked by a reference of its own"})
        bench["workloads"].append({
            "name": f"{name}.live30", "config": name, "traffic": "live30",
            "chips": 1, "why": "config 4's live cell, its own reference"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "c4-1080p-4k.live30" in m.get("workloads", ()):
                m["workloads"].append(f"{name}.live30")
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        return spec.load_cell(f"{name}.live30", root=str(tmp_path))

    yield add
    for name in set(sys.modules) - before:
        if name.startswith(REFERENCE):
            del sys.modules[name]


def test_the_default_reference_is_steps():
    assert spec.reference({}) is steps.make
    assert spec.reference({"reference": "steps"}) is steps.make


@pytest.mark.parametrize("workload", ["c4-1080p-4k.live30",
                                      "c5-4k-learned.live30"])
def test_naming_the_default_gives_the_same_numbers(workload):
    cell = spec.load_cell(workload)
    assert "reference" not in cell.config
    unnamed, named = run(small(cell)), run(small(cell, "steps"))
    assert unnamed["correct"] and named["correct"]
    assert numbers(named) == numbers(unnamed)
    assert numbers(unnamed)[1]["frames_compared"] >= 13
    fp8 = [control.control_numbers(small(cell, r), SEED, CPU, "fp8", span=60)
           for r in (None, "steps")]
    assert fp8[0] == fp8[1]
    assert fp8[0]["bad_byte_share"] > 3 * cell.config["limits"][
        "bad_byte_share"]


@pytest.mark.parametrize("offset, correct", [(1, True), (2, False)])
def test_a_configuration_brings_its_own_reference(added, offset, correct):
    # the check takes a byte one code off as right and two off as wrong;
    # the program's plain path agrees with steps to the code here, so the
    # widest gap is the stand-in's shift, and its verdict follows it
    cell = added("c4-shifted", "shifted", SHIFTED.format(offset=offset))
    out = run(small(cell))
    assert out["correct"] is correct
    assert out["info"]["max_code_gap"] == offset
    assert out["check"]["bad_byte_share"]["value"] == (0.0 if correct
                                                       else 1.0)
    assert out["check"]["missing_frames"]["value"] == 0


def test_the_control_uses_the_named_reference(added):
    # the stand-in computes bf16 whatever it is asked for, so the control
    # through it has nothing to find, where steps' float8 does
    cell = small(added("c4-shifted", "shifted", SHIFTED.format(offset=1)))
    nums = control.control_numbers(cell, SEED, CPU, "fp8", span=60)
    assert nums["bad_byte_share"] == 0.0 and nums["max_code_gap"] == 0
    assert nums["frames_compared"] == 1 + cell.traffic["check_frames"]
    default = control.control_numbers(small(cell, "steps"), SEED, CPU,
                                      "fp8", span=60)
    assert default["bad_byte_share"] > 3 * cell.config["limits"][
        "bad_byte_share"]


@pytest.mark.parametrize("reference, source, message", [
    ("nope", None, "no reference .*fgbench/reference/nope.py"),
    ("frames", None, "reference .*fgbench/reference/frames.py has no make"),
    ("broken", "import no_such_module\n",
     "reference .*fgbench/reference/broken.py fails to load"),
    ("notmake", "make = 3\n",
     "reference .*fgbench/reference/notmake.py has no make"),
    ("../steps", None, "reference '../steps' is not a module name"),
])
def test_a_reference_that_is_not_there_fails_at_load_cell(
        added, reference, source, message):
    with pytest.raises(spec.SpecError,
                       match="fgbench/configs/c4-bad.json: " + message):
        added("c4-bad", reference, source)
