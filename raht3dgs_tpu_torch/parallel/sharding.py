"""Batched frames on one device: the single-device half of the JAX
package's multi-chip module.

Counterpart of ``raht3dgs_tpu/parallel/sharding.py``. Each function there
``jax.vmap``s the per-frame codec over a (B, N, ...) stack of frames that
share one bucketed size; here the frame axis is written out
(``ops/raht_span.py``'s batched forms, ``ops/reorder.py:
coefficient_order_batched``), and the float32 prefix sums of the whole
stack run through the scan kernel's batched entry, one launch per pass.
Zero-weight padding is invisible to the transform and sorts last in the
stream order, and every frame keeps its own real count ``nvox``. Each
frame's result equals the single-frame codec's (``models/pipeline.py``)
on that frame, bit for bit.

The mesh half (``make_mesh``, ``shard_batch``,
``batched_transform_step_tp``) is ROADMAP queue A item 18 and raises.
"""

from __future__ import annotations

import torch

from raht3dgs_tpu_torch.models.pipeline import _quant_T_device
from raht3dgs_tpu_torch.ops.quantize import dequantize, dequantize_biased, quantize
from raht3dgs_tpu_torch.ops.raht_span import (
    _rows_batched,
    raht_forward_span_batched,
    raht_inverse_span_batched,
    raht_structure_span_batched,
)
from raht3dgs_tpu_torch.ops.reorder import coefficient_order_batched


def _mesh_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: a device mesh is not ported yet (ROADMAP queue A, item 18); "
        "the batched functions run on one device")


def make_mesh(n_devices=None, dp=None, tp=None, sp=1):
    raise _mesh_not_ported("make_mesh")


def shard_batch(mesh, codes, attrs, weights):
    raise _mesh_not_ported("shard_batch")


def batched_transform_step_tp(mesh, codes, attrs, weights, steps, depth,
                              order_mode="ragft", nvox=None):
    raise _mesh_not_ported("batched_transform_step_tp")


def _nvox(nvox, codes: torch.Tensor) -> torch.Tensor:
    if nvox is None:
        return torch.full((codes.shape[0],), codes.shape[1], dtype=torch.int32,
                          device=codes.device)
    return torch.as_tensor(nvox, device=codes.device)


def _pads_last_batched(order: torch.Tensor, nvox: torch.Tensor) -> torch.Tensor:
    """``pipeline._pads_last`` of every frame: padding slots (>= that
    frame's nvox) last, the real relative order kept."""
    pads = (order >= nvox[:, None]).to(torch.int8)
    return torch.gather(order, 1, torch.argsort(pads, dim=1, stable=True))


def batched_forward(codes, attrs, weights, depth, order_mode="ragft", nvox=None):
    """Forward RAHT + pads-last coefficient order per frame (no quant).

    codes (B, N) | attrs (B, N, D) | weights (B, N) | nvox (B,) real voxel
    counts. Returns (coeffs (B, N, D), order (B, N) int32) — the
    step-independent half of the encode, reusable across a step sweep.
    ``weight_desc`` takes its order from the structure pass the decoder
    runs, as the single-frame codec does."""
    res = raht_forward_span_batched(codes, attrs, weights, depth)
    structure = res.structure
    if order_mode == "weight_desc":
        structure = raht_structure_span_batched(codes, weights, depth)
    order = coefficient_order_batched(structure, order_mode)
    return res.coeffs, _pads_last_batched(order, _nvox(nvox, codes)).to(torch.int32)


def batched_reorder_T(coeffs, orderp):
    """The per-frame reorder gather + channel-major transpose:
    (B, N, D) -> (B, D, N). Quantization is elementwise and commutes with
    the permutation bitwise, so a sweep reorders once for all its steps."""
    return _rows_batched(coeffs, orderp).transpose(1, 2).contiguous()


def batched_quant_T(coeffs_T, steps, quant_mode="mid", qf=0.0):
    """Quantize reordered (B, D, N) coefficients to int32 symbols; ``steps``
    a (1,) or per-channel (D,) tensor on the coefficients' device."""
    return _quant_T_device(coeffs_T, steps, quant_mode, qf)


def batched_quant_reorder(coeffs, steps, orderp, quant_mode="mid", qf=0.0):
    """Quantize + apply the per-frame pads-last order; (B, D, N) int32,
    each frame's channel a row whose ``[:nvox]`` prefix is its payload."""
    return batched_quant_T(batched_reorder_T(coeffs, orderp), steps, quant_mode, qf)


def batched_transform_step(codes, attrs, weights, steps, depth, order_mode="ragft",
                           nvox=None):
    """:func:`batched_forward` + :func:`batched_quant_reorder` in one call
    (sweeps should use the split pair to reuse the transform)."""
    coeffs, orderp = batched_forward(codes, attrs, weights, depth, order_mode, nvox)
    return batched_quant_reorder(coeffs, steps, orderp)


def batched_inverse_order(codes, weights, nvox, depth, order_mode="ragft"):
    """Per-frame inverse of the pads-last stream permutation (decoder side),
    int32 (B, N)."""
    structure = raht_structure_span_batched(codes, weights, depth)
    order2 = _pads_last_batched(coefficient_order_batched(structure, order_mode),
                                _nvox(nvox, codes))
    return torch.argsort(order2, dim=1, stable=True).to(torch.int32)


def batched_decode_step(codes, weights, qfull, inv, steps, depth,
                        dtype=torch.float64, quant_mode="mid", delta=0.0):
    """Dequantize + inverse RAHT for a batch of frames: ``qfull`` (B, D, N)
    stream-order symbols (pads last), ``inv`` (B, N) from
    :func:`batched_inverse_order`. Returns (B, N, D)."""
    q = _rows_batched(qfull.transpose(1, 2), inv)
    if quant_mode == "deadzone":
        coeffs = dequantize_biased(q, steps, delta, dtype=dtype)
    else:
        coeffs = dequantize(q, steps, dtype=dtype)
    return raht_inverse_span_batched(coeffs, codes, weights, depth)


def batched_roundtrip_step(codes, attrs, weights, steps, depth):
    """Forward, quantize, dequantize and inverse over a batch, and the mean
    squared reconstruction error over every real voxel's channels."""
    res = raht_forward_span_batched(codes, attrs, weights, depth)
    rec = raht_inverse_span_batched(
        dequantize(quantize(res.coeffs, steps), steps, dtype=attrs.dtype),
        codes, weights, depth)
    valid = (weights > 0)[..., None]
    err = torch.where(valid, rec - attrs, torch.zeros((), dtype=attrs.dtype,
                                                      device=attrs.device))
    count = valid.sum() * attrs.shape[2]
    return (err * err).sum() / torch.clamp_min(count, 1)
