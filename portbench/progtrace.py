"""The program's own spans and counters over the profiled units: what
``raht3dgs_tpu_torch.utils.timing.snapshot()`` holds at the end of a
traced run. The program records them only while a profiler records (the
tracer's units), so a run's snapshot covers exactly those units. A
program without ``snapshot`` reads None, and so does every metric read
from it. Reading makes no device call."""

from __future__ import annotations

from typing import Optional

COPY_COUNTERS = ("h2d_bytes_pageable", "h2d_bytes_pinned", "d2h_bytes_pageable",
                 "d2h_bytes_pinned")


def snapshot() -> Optional[dict]:
    try:
        from raht3dgs_tpu_torch.utils import timing
    except ImportError:
        return None
    snap = getattr(timing, "snapshot", None)
    return snap() if callable(snap) else None


def span(name: str) -> Optional[dict]:
    """``{"calls", "roots", "total_s", "self_s"}`` of the program's span
    ``name``, or None where it has none."""
    s = snapshot()
    return None if s is None else s["spans"].get(name)


def counter(name: str) -> Optional[int]:
    """The program's counter ``name``, or None where it has none (or 0)."""
    s = snapshot()
    return None if s is None else s["counts"].get(name) or None


def copy_bytes() -> Optional[int]:
    """Bytes the program copied between the host and the card, pinned and
    pageable, both ways; None where it counts none."""
    s = snapshot()
    if s is None or not any(k in s["counts"] for k in COPY_COUNTERS):
        return None
    return sum(s["counts"].get(k, 0) for k in COPY_COUNTERS)
