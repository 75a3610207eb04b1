"""The readings that set a cell's limits (``limits/<cell>.json``), on the
chip at the cell's own size, in one process so that set-up is paid once:

    python gpubench/tools/readings.py --workload pen.newton \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 21 22 23 \\
        --faults half_batch frozen_after_first --fault-seeds 31 32 33 --out readings.json

For each seed: the program's set-up iterations (the timed path with the
check's capture) and its numbers against the reference (``sound``); the
control, the reference with its matrix products in TF32 put in the
program's place (``control``); the program with a fault planted
(``faults.py``). Prints one JSON line per reading and writes them all to
``--out``. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main() -> int:
    import torch

    from gpubench import faults, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", default="{}", help="JSON job overrides (a smaller cell on the CPU)")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(args.workload)
    dev = torch.device(args.device)
    extra = json.loads(args.set)
    plan = ([("sound", s, None) for s in args.seeds]
            + [("control", s, None) for s in args.control_seeds]
            + [(f, s, faults.FAULTS[f]) for f in args.faults for s in args.fault_seeds])
    rows = []
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for kind, seed, plant in plan:
        t0 = time.perf_counter()
        su = harness.Setup(cell, seed, dev, extra, plant)
        t1 = time.perf_counter()
        su.free()
        if kind == "control":
            numbers = harness.checker(cell).control(cell, su.capture, su.weights, dev)
        else:
            numbers = su.check()
        row = {"kind": kind, "seed": seed, "numbers": numbers, "setup_s": t1 - t0,
               "check_s": time.perf_counter() - t1}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del su
        if args.out:  # after each reading, so that a cut call keeps what it read
            with open(args.out, "w") as f:
                json.dump({"workload": cell.name, "card": harness.card_settings(), "rows": rows},
                          f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
