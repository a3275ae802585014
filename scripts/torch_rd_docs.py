#!/usr/bin/env python3
"""Write the port's RD documents, ``docs/port/rd_<name>.md``: each port RD
tool once at the configuration its JAX document states, with ``--against``
that document.

Each tool runs as its own process (so one failure does not stop the
rest); its output and log go under ``--log-dir``, its exit code and wall
seconds into one JSON line per tool and a closing summary line. A tool's
exit code is nonzero when its table differs from the JAX document's (or,
for the parity tools, when the two legs' streams differ where the
document says they are equal); the document keeps the verdict either way.

    python scripts/torch_rd_docs.py [--only NAME ...] [--device cuda|cpu] \
        [--out-dir docs/port] [--log-dir results/port/rd_docs]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS_3DGS = ["1", "4", "8", "12", "16", "20", "24", "32", "64"]
STEPS_COLOUR = ["1", "2", "4", "6", "8", "12", "16", "20", "24", "32", "64"]
# name -> [(tool, arguments)]: the configurations the JAX documents state
# (the JAX tools' defaults where the document says nothing else)
RUNS = {
    "rd_parity": [("torch_rd_parity_check", ["--n", "30000", "--depth", "10", "--seed", "0"])],
    "rd_parity_3dgs": [("torch_rd_parity_3dgs",
                        ["--n", "20000", "--depth", "10", "--seed", "0",
                         "--steps", "1", "2", "4", "8", "16", "32", "64"])],
    "rd_parity_j18": [("torch_rd_parity_j18", [])],
    "rd_parity_3dgs_full": [("torch_rd_parity_3dgs_full", [])],
    "rd_deadzone": [("torch_rd_deadzone", [])],
    "rd_attr_entropy": [("torch_rd_attr_entropy", [])],
    "rd_predict": [("torch_rd_predict", ["--n", "500000", "--steps", *STEPS_3DGS,
                                         "--color-steps", *STEPS_COLOUR])],
    "rd_temporal": [("torch_rd_temporal", ["--depth", "9", "--frames", "10"]),
                    ("torch_rd_temporal", ["--depth", "8", "--frames", "8", "--append"])],
    "rd_ratecontrol": [("torch_rd_ratecontrol", [])],
    "rd_tiling": [("torch_rd_tiling", [])],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", nargs="+", choices=sorted(RUNS), default=sorted(RUNS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-dir", default="docs/port")
    ap.add_argument("--log-dir", default="results/port/rd_docs")
    args = ap.parse_args(argv)

    os.makedirs(os.path.join(REPO, args.out_dir), exist_ok=True)
    os.makedirs(os.path.join(REPO, args.log_dir), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    results = {}
    for name in args.only:
        out = os.path.join(args.out_dir, f"{name}.md")
        doc = os.path.join("docs", f"{name}.md")
        runs = RUNS[name]
        rc, t0 = 0, time.perf_counter()
        with open(os.path.join(REPO, args.log_dir, f"{name}.log"), "w") as log:
            for i, (tool, extra) in enumerate(runs):
                last = i == len(runs) - 1
                cmd = [sys.executable, os.path.join("scripts", f"{tool}.py"), *extra,
                       "--device", args.device, "--out", out,
                       *(["--against", doc] if last else [])]
                log.write(f"$ {' '.join(cmd)}\n")
                log.flush()
                run = subprocess.run(cmd, cwd=REPO, env=env, stdout=log,
                                     stderr=subprocess.STDOUT)
                rc = rc or run.returncode
        results[name] = {"rc": rc, "seconds": round(time.perf_counter() - t0, 1)}
        print(json.dumps({"tool": name, **results[name]}), flush=True)
    print(json.dumps({"rd_docs": results}))
    return 0 if all(r["rc"] == 0 for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
