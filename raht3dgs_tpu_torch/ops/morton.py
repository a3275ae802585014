"""Morton (Z-order) codes as vectorized integer bit manipulation.

Counterpart of ``raht3dgs_tpu/ops/morton.py``, same bit layout: for level
``i`` the 3-bit digit ``z + 2*y + 4*x`` sits at bit ``3*i``. Codes are
int32 for depth <= 10 and int64 up to depth 20. Depth 21 (uint64 codes with
the padding sentinel on bit 63) is not ported: torch lacks ``>>``, ``<``
and ``cummax`` for uint64, and every int64 code below depth 21 is < 2^63,
so the port stays in signed int64 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of

MAX_DEPTH = 21           # the JAX package's ceiling (uint64 tier)
MAX_PORTED_DEPTH = 20    # the port's int64 ceiling
MAX_DEPTH32 = 10

_SPREAD_MASKS = (
    (32, 0x1F00000000FFFF),
    (16, 0x1F0000FF0000FF),
    (8, 0x100F00F00F00F00F),
    (4, 0x10C30C30C30C30C3),
    (2, 0x1249249249249249),
)
_SPREAD_MASKS32 = (
    (16, 0x30000FF),
    (8, 0x300F00F),
    (4, 0x30C30C3),
    (2, 0x9249249),
)
_COMPACT_MASKS = (
    (2, 0x10C30C30C30C30C3),
    (4, 0x100F00F00F00F00F),
    (8, 0x1F0000FF0000FF),
    (16, 0x1F00000000FFFF),
    (32, 0x1FFFFF),
)
_COMPACT_MASKS32 = (
    (2, 0x30C30C3),
    (4, 0x300F00F),
    (8, 0x30000FF),
    (16, 0x3FF),
)


def _check_depth(depth: int) -> None:
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {MAX_DEPTH}], got {depth}")
    if depth > MAX_PORTED_DEPTH:
        raise NotImplementedError(
            f"depth {depth} needs uint64 Morton codes, not yet ported "
            "(ROADMAP queue A, item 2: the J=21 tier)"
        )


def _spread(x: torch.Tensor, masks, width_mask: int) -> torch.Tensor:
    x = x & width_mask
    for shift, mask in masks:
        x = (x | (x << shift)) & mask
    return x


def _compact(x: torch.Tensor, masks, start_mask: int) -> torch.Tensor:
    x = x & start_mask
    for shift, mask in masks:
        x = (x | (x >> shift)) & mask
    return x


def morton_encode(V, depth: int, *, device: DeviceLike = None) -> torch.Tensor:
    """Interleave integer coordinates ``V[:, 0:3] = (x, y, z)`` into codes.

    ``V`` is an ``(N, 3)`` integer tensor (or array) in ``[0, 2**depth)``.
    Returns ``(N,)`` codes in the low ``3*depth`` bits: int32 for depth <=
    10, int64 above."""
    _check_depth(depth)
    dev = device_of(V, device)
    dt = torch.int32 if depth <= MAX_DEPTH32 else torch.int64
    V = torch.as_tensor(V, device=dev).to(dt)
    lim = (1 << depth) - 1
    x, y, z = V[:, 0] & lim, V[:, 1] & lim, V[:, 2] & lim
    if dt == torch.int32:
        sp = lambda t: _spread(t, _SPREAD_MASKS32, (1 << MAX_DEPTH32) - 1)
    else:
        sp = lambda t: _spread(t, _SPREAD_MASKS, (1 << MAX_DEPTH) - 1)
    return sp(z) | (sp(y) << 1) | (sp(x) << 2)


def morton_decode(codes, depth: int, *, device: DeviceLike = None) -> torch.Tensor:
    """Inverse of :func:`morton_encode`: codes -> ``(N, 3)`` ``(x, y, z)``."""
    _check_depth(depth)
    codes = torch.as_tensor(codes, device=device_of(codes, device))
    lim = (1 << depth) - 1
    if depth <= MAX_DEPTH32 and codes.dtype == torch.int32:
        cp = lambda t: _compact(t, _COMPACT_MASKS32, 0x9249249)
    else:
        codes = codes.to(torch.int64)
        cp = lambda t: _compact(t, _COMPACT_MASKS, 0x1249249249249249)
    z = cp(codes) & lim
    y = cp(codes >> 1) & lim
    x = cp(codes >> 2) & lim
    return torch.stack([x, y, z], dim=1)


def morton_codes_np(Vint: np.ndarray, depth: int) -> np.ndarray:
    """Morton codes of integer coordinates on the host (numpy int64), the
    same bit layout: the port's copy of the JAX package's
    ``ops/prelude.py:morton_codes_np``."""
    V = np.asarray(Vint).astype(np.int64)
    M = np.zeros(V.shape[0], dtype=np.int64)
    for i in range(depth):
        b = (V >> i) & 1
        digit = b[:, 2] + (b[:, 1] << 1) + (b[:, 0] << 2)
        M |= digit << (3 * i)
    return M


def internal_payload_bits(depth: int, n: int) -> int:
    """Bits of code payload for a transform over ``n`` padded slots at depth
    J: real codes take ``3*depth`` bits, padding slots get the unique codes
    ``(1 << payload_bits) + k`` above every real code."""
    pad_index_bits = max(1, (max(n, 1) - 1).bit_length())
    bits = max(3 * depth, pad_index_bits)
    if bits + 1 > 64:
        raise ValueError(
            f"3*depth + pad bit = {bits + 1} exceeds uint64 range (depth={depth})"
        )
    return bits


def code_dtype(depth: int, n: int) -> torch.dtype:
    """Narrowest dtype holding real + padding codes: int32 while the level
    count fits 31 bits, else int64 (the uint64 tier is not ported)."""
    bits = internal_payload_bits(depth, n) + 1
    if bits <= 31:
        return torch.int32
    if bits <= 63:
        return torch.int64
    raise NotImplementedError(
        f"{bits}-bit codes need the uint64 tier, not yet ported "
        "(ROADMAP queue A, item 2: the J=21 tier)"
    )


def pad_code(depth: int, n: int, slot: torch.Tensor) -> torch.Tensor:
    """Sentinel code for padding slot(s) ``slot`` in an ``n``-slot transform."""
    dt = code_dtype(depth, n)
    return (1 << internal_payload_bits(depth, n)) + slot.to(dt)
