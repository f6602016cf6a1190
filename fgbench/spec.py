"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and metrics live in files of their own, found by name:

- ``fgbench/configs/<config>.json``: the engine's settings (``engine``,
  the fields of ``tpufg_torch.config.EngineConfig``), ``precision``, the
  ``checkpoint`` file a learned head reads, and the limits of the numbers
  the check compares (``limits``);
- ``fgbench/traffic/<traffic>.json``: the mix's parameters (see
  ``fgbench/load.py`` and ``fgbench/harness.py``);
- ``fgbench/end_to_end/<metric>.py`` and ``fgbench/metrics/<metric>.py``:
  one reader each, ``read(record) -> float | None`` (None: nothing to read,
  and the metric is left out of the result).

Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(ValueError):
    """A cell or one of its parts is missing or malformed."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # [(metric entry, reader)]
    per_layer: list    # [(metric entry, reader)]


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from None


def reader(kind: str, name: str):
    """The ``read`` function of ``fgbench/<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no reader {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"fgbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(there are {sorted(cells)})")
    w = cells[workload]
    config = _load_json(os.path.join(HERE, "configs", w["config"] + ".json"))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[(m, reader("end_to_end", m["name"]))
                    for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[(m, reader("metrics", m["name"]))
                   for m in bench["per_layer"] if _applies(m, workload)])
