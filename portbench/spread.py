#!/usr/bin/env python3
"""Run a cell several times, each run a process of its own as the check
runs it, and report each metric's spread.

    python3 portbench/spread.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds S] [--trace 0|1] [--sets 2] [--out portbench/.cache/spread.jsonl]

Runs ``portbench/run.py`` once per seed per set (every set the same seeds,
in the same order), appends each run's result line (with its seed, set,
exit code and wall) to ``--out``, and prints, per set and metric, the
median and the spread: the distance between the first and third
quartiles of ``statistics.quantiles(values, n=4)`` over the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--out", default=os.path.join(HERE, ".cache", "spread.jsonl"))
    args = p.parse_args(argv)
    if args.seconds is None:
        with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
            args.seconds = json.load(f)["run_seconds"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)],
                capture_output=True, text=True)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": args.workload, "set": k, "seed": seed, "rc": proc.returncode,
                   "wall_s": wall, "result": res}
            if res is None:
                rec["stderr_tail"] = proc.stderr[-4000:]
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps({"set": k, "seed": seed, "rc": proc.returncode, "wall_s": round(wall, 1),
                              "correct": res and res["correct"],
                              "metrics": res and {m: v["value"] for m, v in res["metrics"].items()},
                              "checks": res and {c: v["value"] for c, v in res["checks"].items()}}),
                  flush=True)
            if res is None:
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
            runs.append(res)
        sets.append(runs)
    for k, runs in enumerate(sets):
        ok = [r for r in runs if r]
        names = sorted({m for r in ok for m in r["metrics"]})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in ok if m in r["metrics"]]
            print(json.dumps({"set": k, "metric": m, "n": len(vals),
                              "median": statistics.median(vals), "spread": spread(vals)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
