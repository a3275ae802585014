"""Morton (Z-order) codes as vectorized integer bit manipulation.

Counterpart of ``raht3dgs_tpu/ops/morton.py``, same bit layout: for level
``i`` the 3-bit digit ``z + 2*y + 4*x`` sits at bit ``3*i``. Codes are
int32 for depth <= 10 and int64 above.

Depth 21 is the JAX package's uint64 tier: real codes take 63 bits and the
padding sentinel ``(1 << 63) + slot`` needs bit 63. PyTorch has no ``<``,
``>>``, ``cummax``, ``sort`` or ``searchsorted`` for uint64, so on a tensor
the port holds these codes in an order-preserving int64 form: bit 63
flipped (``u ^ (1 << 63)`` read as a signed integer). Signed order of the
flipped codes is unsigned order of the JAX package's, and the XOR of two
codes is unchanged by the flip, so sorts, searches, merge levels and the
stream are the JAX package's. :func:`morton_encode` returns that form at
depth 21 and :func:`morton_decode` accepts it; numpy arrays on the host
hold the JAX package's values, and :func:`codes_to_host` /
:func:`codes_from_host` cross between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of, resolve_device

MAX_DEPTH = 21           # the uint64 tier of the JAX package
MAX_DEPTH32 = 10
_BIT63 = -(1 << 63)      # bit 63 as an int64

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


def flipped_tier(depth: int) -> bool:
    """Whether codes at this depth live in the flipped int64 form: real
    codes and the pad bit take ``3*depth + 1 = 64`` bits at depth 21 (the
    pad index bits stay below 63 for any slot count a device can hold)."""
    return 3 * depth + 1 > 63


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
    10, int64 above, in the flipped form at depth 21."""
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
    codes = sp(z) | (sp(y) << 1) | (sp(x) << 2)
    return codes ^ _BIT63 if flipped_tier(depth) else codes


def morton_decode(codes, depth: int, *, device: DeviceLike = None) -> torch.Tensor:
    """Inverse of :func:`morton_encode`: codes -> ``(N, 3)`` ``(x, y, z)``.
    Bit 63 is no coordinate bit, so both int64 forms decode alike: the
    first compact mask keeps bits 0..60, dropping bit 63 and the ones an
    arithmetic shift of a negative code drags into bits 61-62."""
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
    count fits 31 bits, else int64. The JAX package's uint64 tier (64 bits,
    depth 21) is int64 in the flipped form (:func:`flipped_tier`)."""
    bits = internal_payload_bits(depth, n) + 1
    return torch.int32 if bits <= 31 else torch.int64


def pad_code(depth: int, n: int, slot: torch.Tensor) -> torch.Tensor:
    """Sentinel code for padding slot(s) ``slot`` in an ``n``-slot transform,
    in the codes' form: ``(1 << 63) + slot`` flipped is ``slot`` itself."""
    dt = code_dtype(depth, n)
    if flipped_tier(depth):
        return slot.to(dt)
    return (1 << internal_payload_bits(depth, n)) + slot.to(dt)


def codes_to_host(codes, depth: int) -> np.ndarray:
    """Codes of a tensor (or a numpy copy of one) as the JAX package holds
    them: uint64 values at depth 21, else the int32/int64 array as is."""
    c = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    if not flipped_tier(depth) or c.dtype == np.uint64:
        return c
    return c.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def codes_from_host(codes: np.ndarray, depth: int, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """Inverse of :func:`codes_to_host`: the JAX package's codes (uint64 at
    depth 21, or plain int64 there, whose values are the same) as a tensor
    in the port's form. Runs on CUDA unless ``device="cpu"``."""
    c = np.asarray(codes)
    if flipped_tier(depth):
        c = (c.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
    return torch.as_tensor(np.ascontiguousarray(c), device=resolve_device(device))
