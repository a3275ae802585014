"""The benchmark's data-driven core: find a cell's pieces by name, run its
closed loop for a window, read its per-layer metrics and judge its outputs.

Everything that belongs to one configuration, one traffic mix, one kind
of unit or one per-layer metric lives in a file of its own, found by the
name that ``BENCHMARK.json`` gives:

- ``portbench/configs/<config>.json``: the deployment's settings;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with the
  ``kind`` of unit it drives;
- ``portbench/kinds/<kind>.py``: ``setup``, ``unit``, ``check`` and
  ``control`` of that kind of unit (see ``kinds/__init__.py``);
- ``portbench/limits/<workload>.json``: each number compared, its limit;
- ``portbench/metrics/<metric>.py``: ``read(record)``, one per-layer
  metric, None where it finds nothing to read; a metric split by cells
  (``<name>.<part>``) without a file of its own is read by
  ``metrics/<name>.py``.

This module imports nothing of the program; the kinds do.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One workload with everything its name leads to."""

    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    def kind(self):
        return importlib.import_module(f"portbench.kinds.{self.traffic['kind']}")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(HERE, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(w, config, traffic, limits, e2e, layer)


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- spans and the window ----------------------------------------------------


class Spans:
    """Host spans of the benchmark's own files around its calls into each
    layer: seconds by name, and under a profiler a ``record_function``
    range each, so the trace can name what the host did in a device gap."""

    def __init__(self) -> None:
        self.seconds: Dict[str, List[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiling:
            import torch

            rf = torch.profiler.record_function("pb:" + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


class Reservoir:
    """A uniform sample of ``k`` of the window's units, drawn from the seed
    as units complete: unit i is kept with probability k / (i + 1)."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng = rng
        self.k = k
        self.kept: List[Any] = []
        self.seen = 0

    def offer(self) -> Optional[int]:
        """The slot the next unit's outputs go to, or None to drop them."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.kept.append(None)
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot: Optional[int], value: Any) -> None:
        if slot is not None:
            self.kept[slot] = value


@dataclass
class Ctx:
    """What a kind's functions get: the cell, the seed, the device, the
    spans, the stage seconds of the program's timers, counters, and the
    seeded generator of the check's sample."""

    cell: Cell
    seed: int
    device: Any
    spans: Spans = field(default_factory=Spans)
    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    unit_s: List[float] = field(default_factory=list)
    work: float = 0.0
    failed: int = 0
    sample: Optional[Reservoir] = None

    def add_stages(self, stages: Dict[str, float], names=None) -> None:
        for k, v in stages.items():
            if names is None or k in names:
                self.stages[k] = self.stages.get(k, 0.0) + v

    def reset(self) -> None:
        """Forget the counts so far (the set-up's or the profiled units')."""
        self.stages.clear()
        self.counts.clear()
        self.spans.seconds.clear()
        self.work = 0.0

    def count(self, name: str, n: float = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.traffic


def check_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])


def run_window(ctx: Ctx, state, seconds: float, unit: Callable, sync: Callable,
               tracer=None) -> float:
    """Run units back to back (a closed loop) until ``seconds`` have passed;
    the unit in progress at the close is finished and counted. With a
    ``tracer``, the window's first ``trace_units`` units run under the
    profiler, and the program's stage seconds, the spans, the counts and
    the work are counted from the units after them (the profiler's host
    overhead stays out of the per-layer metrics). Returns the window's
    length."""
    trace_units = int(ctx.mix.get("trace_units", 1))
    i = 0
    sync()
    if tracer is not None:
        tracer.start(ctx)
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        unit(ctx, state, i)
        sync()
        u1 = time.perf_counter()
        ctx.unit_s.append(u1 - u0)
        i += 1
        if tracer is not None and tracer.active and (i == trace_units or u1 - t0 >= seconds):
            tracer.stop(ctx)
            if u1 - t0 < seconds:
                ctx.reset()
        if u1 - t0 >= seconds:
            break
    return time.perf_counter() - t0


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number that is absent or not finite
    reads +inf and fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        v = math.inf if v is None or not math.isfinite(v) else float(v)
        out[name] = {"value": v, "limit": float(limit)}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
