"""Rate-targeted encoding: the quantization step that meets a bpp budget.

Counterpart of ``raht3dgs_tpu/models/rd_search.py``. The rate model
(``ops/rate_model.py``) prices a log-spaced grid of steps on the
coefficients' device in one call, the finest step the calibrated model
accepts seeds a few true encodes that correct its bias against the real
coder, and the step is coarsened until the stream fits. The two-pass
allocator finds one step for a whole sequence.

As in the JAX package, the grid quantizes with the plain round-half-up
``quantize`` (whatever the codec's ``quant_mode``) at the coefficients'
dtype, over the transform's own row order (Morton order, pads last) with
``valid = arange(bucket) < n_voxels``; only the true encodes run the
codec's quantizer, entropy coder and, with ``predict=True``, its
predicted closed loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, EncodedFrame, VoxelFrame
# one call for the whole (S, D') step grid, walked in chunks of the grid
from raht3dgs_tpu_torch.ops.rate_model import estimate_bpp_grid as _estimate_bpp_grid


@dataclass
class RateSearchResult:
    step: float
    bpp: float
    target_bpp: float
    encoded: EncodedFrame
    probes: int
    # true encodes run (each a full host entropy encode, and for
    # predict=True the closed loop): the rate model's seed quality
    true_encodes: int = 1


# The surrogate over-estimates the adaptive coder by a stable factor (~1.6x
# on RAHT coefficient statistics across steps); calibrating the target with
# it gets the first true encode close to budget.
MODEL_CALIBRATION = 1.6


def _steps_matrix(grid: np.ndarray, steps_fn) -> np.ndarray:
    return np.stack(
        [np.atleast_1d(np.asarray(steps_fn(s), dtype=np.float64)) for s in grid]
    )


def _grid_estimates(codec: AttributeCodec, frame: VoxelFrame, steps_mat: np.ndarray):
    """The frame's transform and the rate model's bpp at every grid row:
    ``(coeffs, order, (S,) numpy estimates)``."""
    coeffs, order, _, _ = codec.transform(frame)
    valid = torch.arange(frame.codes.shape[0], device=coeffs.device) < frame.n_voxels
    ests = _estimate_bpp_grid(
        coeffs, torch.as_tensor(steps_mat, device=coeffs.device).to(coeffs.dtype),
        valid, frame.n_voxels)
    return coeffs, order, ests.cpu().numpy()


def search_step_for_bpp(
    frame: VoxelFrame,
    target_bpp: float,
    codec: Optional[AttributeCodec] = None,
    lo: float = 0.25,
    hi: float = 4096.0,
    grid_size: int = 64,
    refine: int = 4,
    steps_fn=None,
) -> RateSearchResult:
    """Find the largest-quality (smallest) step with rate <= target_bpp.

    One rate-model call prices ``grid_size`` log-spaced candidate steps;
    the finest qualifying step seeds up to ``refine`` true encodes that
    correct the model's residual bias against the actual coder.
    ``steps_fn(step) -> scalar or (D,) vector`` maps the searched scalar to
    per-channel steps (e.g. the 3DGS per-attribute multipliers); identity
    by default. The default codec runs on the frame's device."""
    if not np.isfinite(target_bpp) or target_bpp <= 0:
        raise ValueError(f"target_bpp must be positive, got {target_bpp}")
    codec = codec or AttributeCodec(frame.depth, device=frame.codes.device)
    if steps_fn is None:
        steps_fn = lambda s: s  # noqa: E731

    est_target = target_bpp * MODEL_CALIBRATION
    grid = np.geomspace(lo, hi, grid_size)
    coeffs, order, ests = _grid_estimates(codec, frame, _steps_matrix(grid, steps_fn))
    probes = 1
    fits = ests <= est_target
    # estimates fall as the step grows: the first qualifying grid point is
    # the finest (highest-quality) step within budget
    step = float(grid[int(np.argmax(fits))]) if fits.any() else hi

    def encode(s):
        return codec.encode(frame, steps=steps_fn(s), coeffs=coeffs, order=order)

    # refine against true encodes
    true_encodes = 1
    enc = encode(step)
    for _ in range(refine):
        actual = enc.stream.bpp()
        if target_bpp * 0.9 <= actual <= target_bpp:
            break
        ratio = actual / target_bpp
        if ratio <= 1.0 and step <= lo:
            break
        new_step = float(np.clip(step * ratio**1.4, lo, hi))
        if new_step == step:
            break  # pinned at a bound: re-encoding is byte-identical
        step = new_step
        true_encodes += 1
        enc = encode(step)
    # guarantee the budget if possible
    while enc.stream.bpp() > target_bpp and step < hi:
        step = float(min(step * 1.3, hi))
        true_encodes += 1
        enc = encode(step)
    return RateSearchResult(
        step=float(step),
        bpp=enc.stream.bpp(),
        target_bpp=target_bpp,
        encoded=enc,
        probes=probes,
        true_encodes=true_encodes,
    )


@dataclass
class GlobalRateSearchResult:
    step: float
    total_bpp: float          # sum(bits) / sum(n_voxels) <= target_bpp
    target_bpp: float
    encoded: list             # one EncodedFrame per input frame
    probes: int


def search_global_step_for_bpp(
    frames,
    target_bpp: float,
    codec: Optional[AttributeCodec] = None,
    lo: float = 0.25,
    hi: float = 4096.0,
    grid_size: int = 64,
    refine: int = 6,
    steps_fn=None,
) -> GlobalRateSearchResult:
    """Two-pass constant-quality allocation: ONE quantization step for
    every frame, the finest whose TOTAL rate fits ``target_bpp *
    sum(n_voxels)``.

    The guarantee is whole-sequence (``sum(actual bits) <= sum(n) *
    target``), not per frame: hard frames get the bits easy frames leave.
    Pass 1 sums the rate model over the frames; pass 2 true-encodes the
    whole sequence, bracketing the total and bisecting it geometrically.
    All frames must share one octree depth (one codec)."""
    if not frames:
        raise ValueError("no frames")
    if not np.isfinite(target_bpp) or target_bpp <= 0:
        raise ValueError(f"target_bpp must be positive, got {target_bpp}")
    codec = codec or AttributeCodec(frames[0].depth, device=frames[0].codes.device)
    if any(f.depth != frames[0].depth for f in frames):
        raise ValueError(
            "two-pass allocation needs a single octree depth across the "
            "sequence (per-frame depths vary — use the per-frame search)"
        )
    if steps_fn is None:
        steps_fn = lambda s: s  # noqa: E731

    grid = np.geomspace(lo, hi, grid_size)
    steps_mat = _steps_matrix(grid, steps_fn)
    total_n = sum(f.n_voxels for f in frames)
    est_bits = np.zeros(grid_size)
    prepared = []
    for f in frames:
        coeffs, order, ests = _grid_estimates(codec, f, steps_mat)
        prepared.append((f, coeffs, order))
        est_bits += ests * f.n_voxels
    probes = len(frames)
    est_target_bits = target_bpp * MODEL_CALIBRATION * total_n
    fits = est_bits <= est_target_bits
    step = float(grid[int(np.argmax(fits))]) if fits.any() else hi

    def encode_all(s):
        return [
            codec.encode(f, steps=steps_fn(s), coeffs=c, order=o)
            for f, c, o in prepared
        ]

    def total_bpp(encs):
        return sum(e.stream.payload_bytes * 8 for e in encs) / total_n

    # bracket [finest known-over, coarsest known-under], then geometric
    # bisection: a multiplicative walk overshoots where rate is steep in
    # step, bisection converges to the finest under-budget step
    encs = encode_all(step)
    best = (step, encs) if total_bpp(encs) <= target_bpp else None
    over = step if best is None else None
    under = step if best is not None else None
    walk = 0
    while over is None and step > lo and walk < 8:
        step = float(max(step / 4.0, lo))
        encs = encode_all(step)
        walk += 1
        if total_bpp(encs) <= target_bpp:
            under, best = step, (step, encs)
        else:
            over = step
    while under is None and step < hi and walk < 16:
        step = float(min(step * 4.0, hi))
        encs = encode_all(step)
        walk += 1
        if total_bpp(encs) <= target_bpp:
            under, best = step, (step, encs)
        else:
            over = step
    if best is None:
        # even `hi` overshoots: the coarsest attempt (the caller sees
        # total_bpp > target and can decide)
        return GlobalRateSearchResult(
            step=float(step), total_bpp=total_bpp(encs),
            target_bpp=target_bpp, encoded=encs, probes=probes,
        )
    for _ in range(refine):
        if over is None or under / over < 1.05:
            break
        mid = float(np.sqrt(over * under))
        encs = encode_all(mid)
        if total_bpp(encs) <= target_bpp:
            under, best = mid, (mid, encs)
        else:
            over = mid
    step, encs = best
    return GlobalRateSearchResult(
        step=float(step),
        total_bpp=total_bpp(encs),
        target_bpp=target_bpp,
        encoded=encs,
        probes=probes,
    )
