#!/usr/bin/env python3
"""The lower-precision control of a cell's correctness check.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--dtype bfloat16]

For each seed: the cell's inputs at its own sizes, a sample drawn as a run
draws it, and the plain reference computed in ``--dtype`` (the precision
below the configuration's float32) put in the program's place, judged by
the same numbers and limits as the program's outputs. Prints one JSON line
a seed; the control has to come out not correct. The benchmark's runs
never run it; ``portbench/tests`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_numbers(cell, seed: int, dtype, device) -> dict:
    from portbench import harness

    ctx = harness.Ctx(cell=cell, seed=seed, device=device)
    ctx.sample = harness.Reservoir(harness.check_rng(seed), int(cell.traffic["check_units"]))
    kind = cell.kind()
    state = kind.control_sample(ctx)
    return harness.judge(kind.control(ctx, state, dtype), cell.limits)


def main(argv=None) -> int:
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        checks = control_numbers(cell, seed, getattr(torch, args.dtype), device)
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype,
                          "correct": harness.passed(checks), "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
