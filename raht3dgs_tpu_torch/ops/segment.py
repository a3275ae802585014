"""Segment sums over runs of sorted rows, with no scatter and no atomics.

Counterpart of ``raht3dgs_tpu/ops/segment.py``. The codec's segments are
runs of a sorted array (points sorted by Morton code), flagged by
``first``; a stable sort of the flags compacts the run starts to the front.
Per-run sums come from one of two reductions:

- ``"shift"`` (default): segmented suffix doubling. After the pass with
  stride ``s`` row ``i`` holds the sum of ``values[i:i+s]`` inside its run,
  so ``ceil(log2(max run))`` passes leave each run's sum on its first row,
  which one row gather collects. The passes and their order are the JAX
  package's, so float lanes come out bitwise equal to its CPU run.
- ``"prefix"``: differences of prefix sums at the run boundaries. float32
  takes the compensated double-single prefix of ``ops/ds_scan.py`` (the
  CUDA kernel on the card, its plain version on the CPU) and a compensated
  difference; float64 a plain float64 cumsum.

Neither uses ``index_add_`` or any other atomic reduction: float atomics
change the order of a sum from run to run, and these sums feed the
encoder. Integer-valued lanes are exact under both while partial sums stay
below 2^24. Results are padded to N slots (run k in slot k, zeros after).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raht3dgs_tpu_torch.ops.ds_scan import ds_prefix_pack
from raht3dgs_tpu_torch.ops.raht_span import _two_sum
from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of

METHODS = ("shift", "prefix")


def segment_starts(first: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row index of each run's first row, compacted to the front.

    Returns (starts (N,) int32 — valid for slots < n_segments, N after;
    n_segments, a 0-d int32 tensor)."""
    N = first.shape[0]
    n_seg = first.to(torch.int32).sum().to(torch.int32)
    # a stable sort of an integer key (0 = run start) keeps starts ascending
    starts = torch.argsort((~first).to(torch.int32), stable=True).to(torch.int32)
    slot = torch.arange(N, dtype=torch.int32, device=first.device)
    return torch.where(slot < n_seg, starts, N), n_seg


def _valid_slots(N: int, n_seg: torch.Tensor) -> torch.Tensor:
    return (torch.arange(N, dtype=torch.int32, device=n_seg.device) < n_seg)[:, None]


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one zero row appended: the gather target of slot N."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def sorted_segment_sums(
    values: torch.Tensor,
    first: torch.Tensor,
    extra_rows: Optional[torch.Tensor] = None,
    method: str = "shift",
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Per-run sums of run-partitioned ``values`` (N, K).

    ``first[i]`` marks the start of a run (``first[0]`` must be True).
    ``extra_rows`` (N, E), if given, is sampled at each run's first row
    through the same gather when the accumulator dtype holds it exactly,
    else through a gather of its own. Tensors stay on their device; host
    arrays go to ``device`` (CUDA unless ``device="cpu"``).

    Returns (sums (N, K) — run k in slot k, zeros in empty slots;
    firsts_extra (N, E) or None; starts (N,) int32; n_segments 0-d int32).
    """
    if method not in METHODS:
        raise ValueError(f"unknown segment-sum method {method!r} (choose from {METHODS})")
    dev = device_of(values, device)
    values, first = torch.as_tensor(values, device=dev), torch.as_tensor(first, device=dev)
    if extra_rows is not None:
        extra_rows = torch.as_tensor(extra_rows, device=dev)
    if method == "shift":
        return _sorted_segment_sums_shift(values, first, extra_rows)
    N, K = values.shape
    starts, n_seg = segment_starts(first)
    use_ds = values.dtype == torch.float32
    if use_ds:
        prefix = ds_prefix_pack(values.contiguous())      # (N+1, 2K) [hi | lo]
        acc_dt, pk = torch.float32, 2 * K
    else:
        P = torch.cumsum(values.to(torch.float64), dim=0)
        prefix = torch.cat([P.new_zeros((1, K)), P])      # row i = sum over [:i)
        acc_dt, pk = torch.float64, K
    # extras ride the boundary gather only where the accumulator holds them
    # exactly (float32 extras in a float32 pack, anything in float64)
    fuse = extra_rows is not None and (not use_ds or extra_rows.dtype == torch.float32)
    pack = torch.cat([prefix, _pad_row(extra_rows).to(acc_dt)], dim=1) if fuse else prefix

    starts_c = starts.to(torch.int64)
    g_start = pack[starts_c]
    # run k ends where run k+1 starts, and the last at prefix[N]: the end
    # rows are the start rows shifted up one slot (one gather, not two)
    g_end = torch.cat([g_start[1:, :pk], prefix[-1:]])
    valid = _valid_slots(N, n_seg)
    if use_ds:
        sm, er = _two_sum(g_end[:, :K], -g_start[:, :K])
        er = er + (g_end[:, K:2 * K] - g_start[:, K:2 * K])
        sums = torch.where(valid, sm + er, 0.0)
    else:
        sums = torch.where(valid, g_end - g_start[:, :K], 0.0)
    if extra_rows is None:
        extra = None
    elif fuse:
        extra = g_start[:, pk:]
    else:
        extra = _pad_row(extra_rows)[starts_c]
    return sums, extra, starts, n_seg


def _sorted_segment_sums_shift(values, first, extra_rows=None):
    """Segmented suffix doubling (see :func:`sorted_segment_sums`): the JAX
    package's loop over a (2N, K) buffer with a zero tail, so the shifted
    read of every pass is one slice; each pass builds its addend from the
    old rows before writing any (no in-place overlapping add)."""
    N, K = values.shape
    starts, n_seg = segment_starts(first)
    starts_c = starts.to(torch.int64)
    ends = torch.cat([starts_c[1:], starts_c.new_full((1,), N)])
    max_run = int((ends - starts_c).max()) if N else 0  # the one host read

    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32)
    seg_pad = torch.cat([seg, seg.new_full((N,), -1)])
    x_pad = torch.cat([values, values.new_zeros((N, K))])
    stride = 1
    while stride < max_run:
        shifted = x_pad[stride:stride + N]
        same = (seg_pad[stride:stride + N] == seg)[:, None]
        add = torch.where(same, shifted, 0)
        x_pad[:N] = x_pad[:N] + add
        stride *= 2

    fuse = extra_rows is not None and extra_rows.dtype == values.dtype
    pack = x_pad[:N + 1]
    if fuse:
        pack = torch.cat([pack, _pad_row(extra_rows)], dim=1)
    g = pack[starts_c]
    sums = torch.where(_valid_slots(N, n_seg), g[:, :K], 0)
    if extra_rows is None:
        extra = None
    elif fuse:
        extra = g[:, K:]
    else:
        extra = _pad_row(extra_rows)[starts_c]
    return sums, extra, starts, n_seg
