"""Reading the device: the profiler's busy share, kernel times and idle
gaps, and the bytes the scan kernel's calls must move.

Frozen copies, so that the yardstick stays fixed while the program
changes:

- :func:`busy_seconds` is the union of the device's kernel, copy and
  memset intervals, ``scripts/profile_torch_port.py:67`` (``_busy_us``).
- The peaks and the scan's bound are ``chip_smoke.py:277-279`` and
  ``:537-547``: the H100 SXM data sheet's 3.35e12 B/s of HBM and 67e12
  float32 operations a second outside the tensor cores, 11 adds or
  subtracts a scanned element (one double-single add), and a call's bound
  ``max(bytes / HBM, operations / F32)``, its bytes each input element
  read once and each output element written once: ``4 (n k + out)`` with
  ``out`` the ``(n + 1) x 2k`` pack or the ``2 x n x k`` (hi, lo) pair, a
  batched call ``B`` times that.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
DS_OPS_PER_ELEM = 11

SPAN_PREFIX = "pb:"
_SCAN_KERNEL = re.compile(r"\bds_[A-Za-z_]+")


def busy_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def scan_call_bound(b: int, n: int, k: int, pack: bool) -> float:
    """The least seconds one scan call on ``b`` frames of ``n`` rows of
    ``k`` float32 columns can take."""
    out = (n + 1) * 2 * k if pack else 2 * n * k
    nbytes = 4.0 * b * (n * k + out)
    ops = DS_OPS_PER_ELEM * b * n * k
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


class ScanRecorder:
    """Counts the scan kernel's calls and their shapes at the boundary of
    its library (``ops/ds_scan.py``'s ``KERNEL``), while ``active``: a proxy
    stands in front of the loaded library and forwards every call. An
    entry it does not know leaves the bound unknown (``bound_s`` None)."""

    _ARGS = {"ds_cumsum_f32": (None, 1, 2, 5), "ds_cumsum_batched_f32": (1, 2, 3, 4)}

    def __init__(self) -> None:
        self.active = False
        self.bound_s: Optional[float] = 0.0

    def install(self) -> None:
        from raht3dgs_tpu_torch.ops import ds_scan

        lib = ds_scan.KERNEL.load()
        if not isinstance(lib, _LibProxy):
            ds_scan.KERNEL._lib = _LibProxy(lib, self)

    def record(self, name: str, args) -> None:
        if not self.active:
            return
        where = self._ARGS.get(name)
        if where is None or self.bound_s is None:
            self.bound_s = None
            return
        bi, ni, ki, pi = where
        b = 1 if bi is None else int(args[bi])
        self.bound_s += scan_call_bound(b, int(args[ni]), int(args[ki]), bool(args[pi]))


class _LibProxy:
    def __init__(self, lib, rec: ScanRecorder):
        self._lib = lib
        self._rec = rec

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("ds_"):
            return fn
        rec = self._rec

        def call(*args):
            rec.record(name, args)
            return fn(*args)

        return call


class Tracer:
    """``torch.profiler`` over the window's first units, with the scan
    recorder on for the same stretch. ``result`` after :meth:`stop`:
    ``window_s`` (host clock, start to stop), ``busy_s``, device seconds by
    kernel name, the ``ds_*`` kernels' seconds, the scan calls' bound and
    the longest idle gaps named by the benchmark span the host was in."""

    def __init__(self) -> None:
        self.prof = None
        self.active = False
        self.scans = ScanRecorder()
        self.result: Optional[dict] = None
        self._t0 = 0.0

    def warm_up(self) -> None:
        """One short profile, so that the profiler's first start (CUPTI's
        set-up, seconds) is not paid in the window."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self, ctx) -> None:
        import time

        import torch

        self.scans.install()
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        ctx.spans.profiling = True
        self.scans.active = True
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self, ctx) -> None:
        import time

        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self.prof.stop()
        ctx.spans.profiling = False
        self.scans.active = False
        self.active = False
        cuda = torch.autograd.DeviceType.CUDA
        dev, host, ops = [], [], []
        for e in self.prof.events():
            if e.name.startswith(SPAN_PREFIX):
                if e.device_type != cuda:
                    host.append((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):]))
            elif e.device_type == cuda:
                dev.append((e.time_range.start, e.time_range.end, e.name))
            else:
                ops.append((e.time_range.start, e.time_range.end, e.name))
        by_name: Dict[str, float] = {}
        scan_s = 0.0
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
            if _SCAN_KERNEL.search(name):
                scan_s += (e - s) * 1e-6
        self.result = {
            "window_s": window_s,
            "busy_s": busy_seconds([(s, e) for s, e, _ in dev]) * 1e-6,
            "kernels": by_name,
            "scan_s": scan_s,
            "scan_bound_s": self.scans.bound_s,
            "gaps": _named_gaps(dev, host, ops),
        }


def _named_gaps(dev, host, ops, top: int = 10):
    """The ``top`` longest device idle gaps inside the traced units (the
    ``unit`` spans), each named by the innermost benchmark span that holds
    its midpoint and, after a ``/``, the innermost host operation the
    profiler recorded there (none while the host runs Python or a native
    library outside PyTorch): ``[[name, seconds], ...]``."""
    units = [(s, e) for s, e, n in host if n == "unit"]
    if not units or not dev:
        return []
    lo, hi = min(s for s, _ in units), max(e for _, e in units)
    busy = _merged([(s, e) for s, e, _ in dev if e > lo and s < hi])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [(e - s, n) for s, e, n in host if s <= mid <= e and n != "unit"]
        name = min(inner)[1] if inner else "unit"
        op = [(e - s, n) for s, e, n in ops if s <= mid <= e]
        if op:
            name += "/" + min(op)[1]
        gaps.append((b - a, name))
    gaps.sort(reverse=True)
    return [[f"host:{n}", d * 1e-6] for d, n in gaps[:top]]


def breakdown(result: dict, top: int = 10) -> dict:
    ops = sorted(result["kernels"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": result["gaps"]}
