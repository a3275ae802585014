"""Shared RAHT types and helpers.

Counterpart of the shared part of ``raht3dgs_tpu/ops/raht.py``
(``num_levels``, ``RahtStructure``, ``RahtForwardResult``,
``_butterfly_ab``, ``_code_lanes`` / ``_lanes_code``). The dense level loop of that module is not ported yet
(ROADMAP queue A, item 17); the codec's transform is ``ops/raht_span.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import internal_payload_bits


def num_levels(depth: int, n: int) -> int:
    """Total butterfly levels for an ``n``-slot transform at octree depth J:
    the real ``3*depth`` levels plus the padding subtree's range."""
    return internal_payload_bits(depth, n) + 1


def max_int32_levels() -> int:
    """Largest level count representable with int32 codes (incl. pad bit)."""
    return 31


class RahtStructure(NamedTuple):
    drop_level: torch.Tensor    # (N,) int32: level the slot merged right-into-left; 0 = survivor
    subtree_w: torch.Tensor     # (N,) float: accumulated weight when merged (survivor: final)
    node_weights: torch.Tensor  # (N,) float: final accumulated node weights


class RahtForwardResult(NamedTuple):
    coeffs: torch.Tensor        # (N, D) coefficients, in sorted-code order
    weights: torch.Tensor       # (N,) final accumulated node weights
    structure: RahtStructure


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every device.

    ``torch.sqrt`` on a CPU tensor takes a vectorized path that misses the
    correctly rounded result in the last bit for about 1% of inputs; the
    CUDA one and numpy's are IEEE. The transform's coefficients (and so the
    stream's symbols at quantization ties) must not depend on the device,
    so CPU tensors go through numpy."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


# Codes ride a wide float row gather as value-exact digits: float32 holds
# integers below 2^24 exactly, and three 22-bit digits cover every code.
_DIGIT_BITS = 22
_DIGIT_MASK = (1 << _DIGIT_BITS) - 1


def _code_lanes(codes: torch.Tensor, fdtype) -> torch.Tensor:
    """Split integer codes into (N, 3) exact float digits (low to high)."""
    c = codes.to(torch.int64)
    return torch.stack([(c & _DIGIT_MASK).to(fdtype),
                        ((c >> _DIGIT_BITS) & _DIGIT_MASK).to(fdtype),
                        ((c >> (2 * _DIGIT_BITS)) & _DIGIT_MASK).to(fdtype)], dim=1)


def _lanes_code(lanes: torch.Tensor, code_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_code_lanes`."""
    lo, mid, hi = (lanes[:, i].to(torch.int64) for i in range(3))
    return (lo | (mid << _DIGIT_BITS) | (hi << (2 * _DIGIT_BITS))).to(code_dtype)


def _butterfly_ab(w0: torch.Tensor, w1: torch.Tensor):
    """Orthonormal butterfly coefficients; identity for zero-weight pairs."""
    denom = w0 + w1
    safe = denom > 0
    d = torch.where(safe, denom, torch.ones_like(denom))
    a = torch.where(safe, ieee_sqrt(w0 / d), torch.ones_like(denom))
    b = torch.where(safe, ieee_sqrt(w1 / d), torch.zeros_like(denom))
    return a, b
