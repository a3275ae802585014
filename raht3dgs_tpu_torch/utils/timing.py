"""Per-stage wall-clock timing with device synchronization, and the
program's spans and counters on the profiler's clock.

Counterpart of ``raht3dgs_tpu/utils/timing.py``: each stage is bracketed by
a synchronization of every CUDA device that holds PyTorch memory, so launch
overhead and device execution are both captured, on a device mesh too
(``torch.cuda.synchronize()`` alone waits for the current device only).
Stage names mirror the reference CSV schemas.

**Spans and counters.** They record exactly while a ``torch.profiler``
session records in the calling thread (:func:`enabled`, PyTorch's
``_profiler_enabled()``, about 100 ns): the benchmark's traced window,
or a CLI's ``--profile DIR``. Off, :func:`span` makes that one check and
returns a shared no-op context; :func:`count` makes it and returns. On, a
span records its name, start and end (``perf_counter_ns``), its parent,
its thread and a request id, and opens a profiler range ``r3:<name>``
(with the request id among its arguments), so it lies on the device
trace's clock; no span synchronizes the device. A span opened with no
span around it is a root and takes a fresh request id; every span under
it shares that id. The range's scope is a function's, not a user
range's, so the profiler draws no device-side annotation over the
kernels a span launches (a device busy share stays the kernels' own).

Spans, by layer (the request roots first):

- roots: ``prepare_frame_batch``, ``prelude`` (``prepare_voxel_frame``),
  ``transform`` (``BatchAttributeCodec.transform``), ``encode_sweep`` and
  ``decode`` (both codecs), ``encode_gs_frame``, ``merge``
  (``compress_to_nvox``), ``serve`` (a frame of ``models/serving.py``);
- frame preparation: ``prelude`` > ``host_sort``, ``upload``;
- voxelizer and merge: ``merge`` > ``upload``, ``voxelize_merge``,
  ``download``;
- every :class:`StageTimer` stage timed by :meth:`StageTimer.time`, under
  its CSV name (``RAHT_prelude_time``, ``RAHT_transform_time``,
  ``Quant_time``, ``Coeff_reorder_dec_time``, ``Dequant_time``,
  ``iRAHT_time``, ``voxelize_merge``);
- host entropy coder: ``rlgr_encode``, ``rlgr_decode`` (the native batch
  calls of ``codec/rlgr.py``);
- quality scoring: ``psnr`` (``y_psnr_db``; ``gs_group_psnr``, numpy or, on a
  float32 pair, the fused native pass of ``native/sq_diff.cpp``);
- serving: ``serve`` > ``geometry``, ``rlgr_decode``, ``upload``,
  ``inverse``, ``render``;
- rasterizer: ``render`` (a view of ``parallel/render.py:render_views``) >
  ``project``, ``bin``, ``blend`` (``eval/rasterize.py``).

Counters (:data:`COUNTS`): ``h2d_bytes_pageable``, ``h2d_bytes_pinned``,
``d2h_bytes_pageable``, ``d2h_bytes_pinned`` (``utils/device.py``'s copy
helpers), ``voxel_steps`` (voxels x steps of each ``encode_sweep``),
``frames_prepared``, ``rlgr_job_ns`` (the sum of the native jobs' own
nanoseconds), ``rlgr_thread_slots`` (each batch call's wall ns x the
pool's threads), ``psnr_fused`` (``gs_group_psnr`` calls that took the
fused pass), ``upload_pack_native`` (``pack_quantized_upload`` calls that
took the native pass of ``native/upload_pack.cpp``) and the rasterizer's
``raster_views``, ``raster_chunks``, ``raster_syncs`` and
``raster_entries`` (``eval/rasterize.py:COUNTS``).
:func:`snapshot` reads them, :func:`reset` clears them.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "r3:"

#: whether a profiler records in the calling thread (spans and counters
#: record exactly then)
enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_lock = threading.Lock()
_PARENT: contextvars.ContextVar = contextvars.ContextVar("r3_span", default=None)


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    self_ns: int     # the duration less the union of its children
    id: int
    parent: Optional[int]
    request: int
    thread: int
    outer: bool      # no span of the same name around it


SPANS: List[SpanRecord] = []
COUNTS: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "parent", "request", "id", "thread", "outer", "children",
                 "t0", "_rf", "_token")

    def __init__(self, name: str, parent: Optional["_Span"], request: Optional[int]):
        self.name = name
        self.parent = parent
        self.request = next(_ids) if request is None else request
        self.id = next(_ids)
        self.thread = threading.get_ident()
        p = parent
        while p is not None and p.name != name:
            p = p.parent
        self.outer = p is None
        self.children: List[Tuple[int, int]] = []

    def __enter__(self) -> "_Span":
        # the request id reaches a chrome trace's args when the profiler
        # records shapes (the CLIs' --profile)
        self._rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name, [],
                                                          {"request": self.request})
        self._rf.__enter__()
        self._token = _PARENT.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        _PARENT.reset(self._token)
        self._rf.__exit__(None, None, None)
        covered, end = 0, self.t0
        for s, e in sorted(self.children):
            s = max(s, end)
            if e > s:
                covered += e - s
                end = e
        p = self.parent
        SPANS.append(SpanRecord(self.name, self.t0, t1, t1 - self.t0 - covered, self.id,
                                None if p is None else p.id, self.request, self.thread,
                                self.outer))
        if p is not None:
            p.children.append((self.t0, t1))
        return False


def span(name: str):
    """A context for one named stretch of the program; a no-op unless a
    profiler records in this thread."""
    if not enabled():
        return _OFF
    parent = _PARENT.get()
    return _Span(name, parent, None if parent is None else parent.request)


def spanned(name: str):
    """Decorator: every call of the function runs in :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not enabled():
        return
    with _lock:
        COUNTS[name] = COUNTS.get(name, 0) + n


def snapshot() -> Dict[str, Any]:
    """``{"spans": {name: {"calls", "roots", "total_s", "self_s"}},
    "counts": {...}}`` over everything recorded since :func:`reset`.
    ``total_s`` sums a name's outermost spans (one nested in a span of its
    own name is inside that one's total); ``roots`` counts its spans that
    have no parent."""
    spans: Dict[str, Dict[str, float]] = {}
    for r in list(SPANS):
        s = spans.setdefault(r.name, {"calls": 0, "roots": 0, "total_s": 0.0, "self_s": 0.0})
        s["calls"] += 1
        s["roots"] += r.parent is None
        if r.outer:
            s["total_s"] += (r.end_ns - r.start_ns) / 1e9
        s["self_s"] += r.self_ns / 1e9
    with _lock:
        counts = dict(COUNTS)
    return {"spans": spans, "counts": counts}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    SPANS.clear()
    with _lock:
        COUNTS.clear()


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
        """``fn(*args, **kwargs)`` between two device syncs, its seconds
        added to stage ``name``; under a profiler also the span ``name``."""
        _sync()
        with span(name):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    def add(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def get(self, name: str, default: float = 0.0) -> float:
        return self.stages.get(name, default)
