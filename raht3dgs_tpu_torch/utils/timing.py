"""Per-stage wall-clock timing with device synchronization.

Counterpart of ``raht3dgs_tpu/utils/timing.py``: each stage is bracketed by
a synchronization of every CUDA device that holds PyTorch memory, so launch
overhead and device execution are both captured, on a device mesh too
(``torch.cuda.synchronize()`` alone waits for the current device only).
Stage names mirror the reference CSV schemas.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch


def _sync() -> None:
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    n = torch.cuda.device_count()
    if n == 1:
        torch.cuda.synchronize()
        return
    # a device without memory of PyTorch's ran none of the timed work;
    # synchronizing it would create a context there
    for d in range(n):
        if torch.cuda.memory_reserved(d):
            torch.cuda.synchronize(d)


class StageTimer:
    """Collects named stage durations (seconds)."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    def time(self, name: str, fn, *args, **kwargs) -> Any:
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    def add(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def get(self, name: str, default: float = 0.0) -> float:
        return self.stages.get(name, default)
