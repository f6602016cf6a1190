"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and metrics live in files of their own, found by name:

- ``fgbench/configs/<config>.json``: the engine's settings (``engine``,
  the fields of ``tpufg_torch.config.EngineConfig``), ``precision``, the
  ``checkpoint`` file a learned head reads, the limits of the numbers
  the check compares (``limits``) and, optionally, the ``reference`` that
  decides them;
- ``fgbench/reference/<reference>.py``: the plain reference of the
  configurations that name it, whose ``make(config, precision, device,
  root)`` returns the object the check drives (``fgbench/reference/``'s
  docstring gives the protocol); a configuration without the key takes
  ``steps``, the reference of configs 4 and 5;
- ``fgbench/traffic/<traffic>.json``: the mix's parameters (see
  ``fgbench/load.py`` and ``fgbench/harness.py``);
- ``fgbench/end_to_end/<metric>.py`` and ``fgbench/metrics/<metric>.py``:
  one reader each, ``read(record) -> float | None`` (None: nothing to read,
  and the metric is left out of the result).

Adding a cell, a configuration (with a reference of its own), a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_REFERENCE = "steps"


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


def reference(config: dict):
    """The ``make`` function of the reference module ``config`` names
    (``fgbench/reference/<name>.py``; ``steps`` where it names none)."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not isinstance(name, str) or not name.isidentifier():
        raise SpecError(f"reference {name!r} is not a module name")
    path = os.path.join(HERE, "reference", name + ".py")
    where = os.path.relpath(path, ROOT)
    if not os.path.isfile(path):
        raise SpecError(f"no reference {where}")
    # registered as imported, so that a dataclass or a later import of the
    # same file finds it; one of that name from another file (a copy of the
    # benchmark's) is replaced
    full = f"fgbench.reference.{name}"
    mod = sys.modules.get(full)
    if getattr(mod, "__file__", None) != path:
        spec = importlib.util.spec_from_file_location(full, path)
        mod = sys.modules[full] = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            del sys.modules[full]
            raise SpecError(f"reference {where} fails to load: {e!r}") from e
    if not callable(getattr(mod, "make", None)):
        raise SpecError(f"reference {where} has no make(config, precision, "
                        f"device, root)")
    return mod.make


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(there are {sorted(cells)})")
    w = cells[workload]
    config_path = os.path.join(HERE, "configs", w["config"] + ".json")
    config = _load_json(config_path)
    try:
        reference(config)
    except SpecError as e:
        raise SpecError(f"{os.path.relpath(config_path, ROOT)}: {e}") \
            from e
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[(m, reader("end_to_end", m["name"]))
                    for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[(m, reader("metrics", m["name"]))
                   for m in bench["per_layer"] if _applies(m, workload)])
