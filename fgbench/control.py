"""The check's control: the configuration's reference (``spec.reference``)
computed one precision below the one the configuration states (float8
e4m3 where it states bf16), put in the program's place and judged by the
same comparison, must come out not correct.  Its numbers are the upper
readings the limits in ``fgbench/configs/*.json`` are set below.

    python3 fgbench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's bank, draws as many frames as a run
checks (frame 0 and ``check_frames`` more, over the frames a window
holds), and prints one JSON line of the numbers.  It runs no part of the
program, and the benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fgbench import check, load  # noqa: E402
from fgbench.spec import ROOT, load_cell, reference  # noqa: E402


def control_numbers(cell, seed: int, device: torch.device,
                    precision: str = "fp8", span: int = 1200,
                    root: str = ROOT) -> dict:
    """The check's numbers with the reference in ``precision`` in the
    program's place, on ``check_frames`` frames of ``span`` drawn from
    ``seed``, and frame 0."""
    e, tr = cell.config["engine"], cell.traffic
    bank = load.make_bank(seed, e["input_height"], e["input_width"],
                          tr["bank_frames"], tr["max_speed"], device)
    rng = np.random.default_rng([int(seed), 0xC0FFEE])
    picks = [0] + sorted(int(i) for i in rng.choice(
        np.arange(1, span), size=tr["check_frames"], replace=False))
    make = reference(cell.config)
    stand_in = make(cell.config, precision, device, root)
    ref = make(cell.config, "bf16", device, root)
    n, wire = len(bank), tr["sink_wire"]

    def frame(i):
        return torch.from_numpy(bank[load.bank_index(i, n)]).to(device)

    frames = {}
    with torch.no_grad():
        for i in picks:
            outs = (stand_in.first(frame(0)) if i == 0
                    else stand_in.pair(frame(i - 1), frame(i)))
            frames[i] = [stand_in.wire(o, wire).cpu().numpy() for o in outs]
    return check.compare(frames, wire, bank, ref, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 fgbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fgbench: the control runs on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "precision": "fp8",
                          "seed": seed, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
