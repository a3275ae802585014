#!/usr/bin/env python3
"""Readings of a cell's correctness numbers over many seeds, in one process.

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 5] [--fault <name>]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds`` at the cell's own load, the check of a sample as
large as a full run's), in one process so the CUDA context and the built
libraries are paid once. ``--fault`` plants one of the faults of
``tests/test_portbench_faults.py`` in the program for every seed (the
reading of that fault at the cell's own size). Prints one JSON line a
seed with each number beside its limit and the seconds the check took.
The limits in ``limits/<cell>.json`` are set from these readings and the
control's (``control.py``), as ``PERF.md`` records; the benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from portbench import harness, run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    kind = harness.find_cell(args.workload).kind()
    timed = {}
    real_check = kind.check

    def check(ctx, state):
        t0 = time.perf_counter()
        try:
            return real_check(ctx, state)
        finally:
            timed["check_s"] = time.perf_counter() - t0

    kind.check = check
    patch = None
    if args.fault:
        import pytest

        from portbench.tests import test_portbench_faults as faults

        patch = pytest.MonkeyPatch()
        getattr(faults, "_" + args.fault)(patch)
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            res = run.run(argparse.Namespace(workload=args.workload, seed=seed,
                                             seconds=args.seconds, trace=0))
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                              "correct": res["correct"], "attempted": res["attempted"],
                              "check_s": timed.get("check_s"),
                              "wall_s": time.perf_counter() - t0, "checks": res["checks"]}),
                  flush=True)
    finally:
        if patch is not None:
            patch.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
