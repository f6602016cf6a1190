"""The benchmark's files: every part of every cell is found by name, the
benchmark description keeps to its contract's shape, and nothing in
``fgbench/`` imports JAX or the JAX package (``fgbench/reference/``
imports nothing of the port either)."""

import ast
import json
import os
import re

import pytest

from fgbench import spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.traffic["name"] == next(
        w["traffic"] for w in BENCH["workloads"] if w["name"] == workload)
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m, read in cell.end_to_end + cell.per_layer:
        assert callable(read), m["name"]
    # every per-layer metric's cell reports the end-to-end metric it moves
    for m, _ in cell.per_layer:
        assert m["moves"] in e2e, (workload, m["name"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    folder = "end_to_end" if kind == "end_to_end" else "metrics"
    for m in BENCH[kind]:
        assert callable(spec.reader(folder, m["name"]))


def test_a_missing_part_is_named():
    with pytest.raises(spec.SpecError, match="no workload"):
        spec.load_cell("no-such-cell")
    with pytest.raises(spec.SpecError, match="no reader"):
        spec.reader("metrics", "no-such-metric")


def test_configuration_files():
    from tpufg_torch.config import EngineConfig
    files = set()
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("fgbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(path))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        EngineConfig(**cfg["engine"]).validate()
        assert set(cfg["limits"]) == {"missing_frames", "bad_byte_share"}
        assert cfg["limits"]["missing_frames"] == 0
        if cfg.get("checkpoint"):
            assert os.path.isfile(os.path.join(ROOT, cfg["checkpoint"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fgbench/run.py"]
    assert BENCH["paths"] == ["fgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                                cells))
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(layers) >= 3


def _imports(path):
    """Every module ``path`` imports, a relative import resolved from the
    file's package (in ``fgbench/reference/x.py``, ``from ..check import
    compare`` imports ``fgbench.check``)."""
    package = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) + 1 - node.level] if node.level \
                else []
            yield ".".join(base + ([node.module] if node.module else []))


def _sources(folder):
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    bad = {"jax", "jaxlib", "flax", "tpufg"}
    found = [(p, m) for p in _sources(spec.HERE) for m in _imports(p)
             if m.split(".")[0] in bad]
    assert found == []


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(spec.HERE, "reference")
    found = [(p, m) for p in _sources(ref) for m in _imports(p)
             if m.split(".")[0] in {"tpufg_torch", "jax", "tpufg"}]
    assert found == []
    # and names only plain libraries and itself
    tops = {m.split(".")[0] for p in _sources(ref) for m in _imports(p)}
    assert tops <= {"__future__", "contextlib", "functools", "json", "re",
                    "os", "typing", "numpy", "torch", "fgbench"}
    # of the benchmark, only the reference package and its own modules
    assert [(p, m) for p in _sources(ref) for m in _imports(p)
            if m.split(".")[0] == "fgbench"
            and m.split(".")[:2] != ["fgbench", "reference"]] == []


def test_forbidden_names_are_compared_whole():
    from fgbench.run import forbidden_modules
    assert forbidden_modules(["tpufg_torch", "tpufg_torch.engine.runner",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "tpufg", "tpufg.ops",
                              "flax.linen"]) == ["flax", "jax", "tpufg"]
