#!/usr/bin/env python3
"""Run one cell of the benchmark of ``raht3dgs_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program, on a machine with the
CUDA cards the cell asks for. Set-up makes the cell's inputs from the
seed on the card and warms up every shape the window uses; the window runs
the cell's closed loop for ``--seconds`` (the unit in progress at the close
is finished and counted); then the program's device state is freed and its
sampled outputs are judged against the plain reference
(``portbench/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit, which also close standard error.

Exits non-zero with no result line without a card (or with fewer cards
than the cell asks for), without the program, or when a JAX module is
loaded at the close of the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "raht3dgs_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, cell=None, device: str = "cuda") -> dict:
    """One run of a cell; returns the result object. A ``cell`` given by
    the caller (the benchmark's own tests, with ``device="cpu"`` and small
    sizes) skips the look for a card."""
    import torch

    from portbench import devtrace, harness

    given = cell is not None
    cell = cell or harness.find_cell(args.workload)
    kind = cell.kind()
    if not given:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"portbench: {args.workload} needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                             " visible")
    import raht3dgs_tpu_torch  # noqa: F401  (fails here, with no result, without the program)

    ctx = harness.Ctx(cell=cell, seed=args.seed, device=torch.device(device))
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state = kind.setup(ctx)
    sync()
    setup_s = time.perf_counter() - T_START
    ctx.reset()
    ctx.sample = harness.Reservoir(harness.check_rng(args.seed), int(cell.traffic["check_units"]))
    tracer = devtrace.Tracer() if args.trace and cuda else None
    if tracer is not None:
        tracer.warm_up()  # the profiler's own start-up stays out of the window
    window_s = harness.run_window(ctx, state, args.seconds, kind.unit, sync, tracer)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {', '.join(found)}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    kind.release(state)
    if cuda:
        torch.cuda.empty_cache()
    record = {"cell": cell.name, "window_s": window_s, "units": len(ctx.unit_s),
              "unit_s": ctx.unit_s, "work": ctx.work, "stages": ctx.stages,
              "spans": ctx.spans.seconds, "counts": ctx.counts, "setup_s": setup_s,
              "profile": tracer.result if tracer is not None else None}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tracer is not None and tracer.result is not None:
            device_info["busy_s"] = tracer.result["busy_s"]
            device_info["window_s"] = tracer.result["window_s"]
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else \
                harness.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = harness.judge(kind.check(ctx, state), cell.limits)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {', '.join(found)}")
    result = {"correct": harness.passed(checks), "attempted": len(ctx.unit_s),
              "failed": ctx.failed, "metrics": metrics, "device": device_info}
    if tracer is not None and tracer.result is not None:
        result["breakdown"] = devtrace.breakdown(tracer.result)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = run(args)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
