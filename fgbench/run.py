"""The benchmark of tpufg_torch, one run of one cell:

    python3 fgbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout that holds the port (``tpufg_torch/``)
and its bundled checkpoints.  The cells are named in ``BENCHMARK.json``;
their parts are found by name under ``fgbench/`` (``fgbench/spec.py``).

It prints, as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (read from a profiler trace of the window) and the
``breakdown`` of the device's time; the numbers the check compared, each
with its limit, come last there and as the last lines of standard error.

Exit codes: 0 a result was printed; 2 no CUDA device (or fewer than the
cell asks for), no port to run, or a cell that cannot be found; 3 a JAX
module was loaded in this process.  No result is printed unless the code
is 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# the checkout's root, so that `python3 fgbench/run.py` finds the packages
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# torch's OpenMP workers (they copy every frame into pinned memory) sleep
# once a copy is done instead of spinning for milliseconds: spinning, they
# held five of an 8-core host's cores through a 4K window and left the
# engine's one enqueueing thread to wait for a core.  Set before torch is
# imported, which reads it once.
os.environ["OMP_WAIT_POLICY"] = "PASSIVE"

from fgbench import harness, spec  # noqa: E402

# top-level modules the run must not load (compared by whole name: the
# port's ``tpufg_torch`` is not ``tpufg``)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufg")


def forbidden_modules(names) -> list:
    return sorted({n.split(".")[0] for n in names}
                  & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 fgbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"fgbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        return fail(2, str(e))
    import torch
    if not torch.cuda.is_available():
        return fail(2, "no CUDA device (torch.cuda.is_available() is "
                       "False): the benchmark times the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(2, f"{args.workload} needs {cell.chips} CUDA devices, "
                       f"{torch.cuda.device_count()} present")
    try:
        import tpufg_torch  # noqa: F401
    except ImportError as e:
        return fail(2, f"the port tpufg_torch cannot be imported: {e}")
    if cell.config.get("checkpoint") and not os.path.isfile(
            os.path.join(spec.ROOT, cell.config["checkpoint"])):
        return fail(2, f"missing {cell.config['checkpoint']}")
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    found = forbidden_modules(sys.modules)
    if found:
        return fail(3, f"JAX modules loaded in this process: {found}")
    for name, row in out["check"].items():
        print(f"check: {name} {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
