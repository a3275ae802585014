"""Per-stage wall-clock timing with device synchronization.

Counterpart of ``raht3dgs_tpu/utils/timing.py``: each stage is bracketed by
``torch.cuda.synchronize()`` so launch overhead and device execution are
both captured. Stage names mirror the reference CSV schemas.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
