#!/usr/bin/env python3
"""What the program's spans and counters (``raht3dgs_tpu_torch/utils/
timing.py``) cost the host, in ns a call.

    python3 scripts/trace_cost.py [--calls N]

Times, each over ``N`` calls in a loop (the empty loop's ns reported
apart): a span entered and left and a counter added while tracing is off
(no profiler), the copy helper's count while off, and a span and a
counter while a CPU ``torch.profiler`` records. Prints one JSON line with
the host's CPUs (online, and usable by this process), the threads the
RLGR coder's pool starts for a 56-channel batch, and the torch version. A
span's own cost only: the profiler's cost for the kernels and copies it
records is not in it.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from raht3dgs_tpu_torch.codec import rlgr  # noqa: E402
from raht3dgs_tpu_torch.utils import device, timing  # noqa: E402


def per_call_ns(fn, calls: int) -> float:
    t0 = time.perf_counter_ns()
    fn(calls)
    return (time.perf_counter_ns() - t0) / calls


def empty(n):
    for _ in range(n):
        pass


def spans(n):
    for _ in range(n):
        with timing.span("cost"):
            pass


def counts(n):
    for _ in range(n):
        timing.count("cost", 1)


def copies(n, t=torch.zeros(4)):
    for _ in range(n):
        device.count_copy("h2d", t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=200_000)
    a = p.parse_args(argv)
    out = {"torch": torch.__version__, "cpu": platform.processor() or platform.machine(),
           "cpus": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0)),
           "rlgr_pool_56_jobs": int(rlgr.NATIVE.load().rlgr_pool_size(56, 0)),
           "calls": a.calls}
    for rep in range(2):  # the first pass warms up
        out["empty_loop_ns"] = per_call_ns(empty, a.calls)
        out["span_off_ns"] = per_call_ns(spans, a.calls)
        out["count_off_ns"] = per_call_ns(counts, a.calls)
        out["copy_count_off_ns"] = per_call_ns(copies, a.calls)
    on = max(a.calls // 20, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["span_on_ns"] = per_call_ns(spans, on)
        out["count_on_ns"] = per_call_ns(counts, on)
    timing.reset()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
