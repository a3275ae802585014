"""Ragged RAHT prelude and list-based transforms: the host golden.

Counterpart of ``raht3dgs_tpu/ops/prelude.py``: the reference's per-level
ragged representation (``List`` group starts, ``Flags`` sibling pairing,
``weights`` run lengths) and its RA-GFT output order in numpy with MATLAB
semantics, and the list-based forward and inverse transforms it drives.
It serves the ``impl="golden"`` byte-parity codec (``models/pipeline.py``)
and the ``.mat`` crosscheck (``crosscheck.py``). Host code in both
packages: it runs on numpy, never on the card.
"""

from __future__ import annotations

from typing import List as TList, Optional, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import morton_codes_np

__all__ = ["morton_codes_np", "prelude", "parity_sqrt", "raht_forward_lists",
           "raht_inverse_lists"]


def prelude(
    codes: np.ndarray, nbits: int
) -> Tuple[TList[np.ndarray], TList[np.ndarray], TList[np.ndarray], np.ndarray]:
    """Build per-level ``List/Flags/weights`` + ``order_RAGFT`` (0-based).

    ``codes`` must be in Morton order (the reference assumes this of its
    input; see ``utils.is_frame_morton_ordered``). Semantics match
    ``RAHT_param_reorder_fast`` (``RAHT_param.py:191-279``) including the
    every-3rd-level RA-GFT checkpointing and the two termination rules
    (single survivor, or level budget ``nbits`` exhausted).
    """
    N = codes.shape[0]
    if N == 1:
        return (
            [np.zeros(1, dtype=np.int64)],
            [np.array([False])],
            [np.ones(1, dtype=np.int64)],
            np.zeros(1, dtype=np.int64),
        )

    curr = np.arange(N, dtype=np.int64)
    Lists: TList[np.ndarray] = [curr]
    Flags: TList[np.ndarray] = []
    weights: TList[np.ndarray] = []
    groups: TList[np.ndarray] = []
    pre = np.zeros(N, dtype=bool)
    order: Optional[np.ndarray] = None

    for j in range(1, 65):
        nxt = np.append(curr[1:], N)
        weights.append((nxt - curr).astype(np.int64))

        Mj = codes[curr]
        if Mj.size == 1:
            Flags.append(np.array([False]))
            break

        mask = np.int64((1 << nbits) - (1 << j))
        eq = ((Mj[:-1] ^ Mj[1:]) & mask) == 0
        flag = np.append(eq, False)
        Flags.append(flag)

        prev = np.concatenate([[False], flag[:-1]])
        tmp = curr[~prev]

        if j % 3 == 0 and j > 2:
            ind = np.zeros(N, dtype=bool)
            ind[tmp] = True
            if j == 3:
                groups.append(np.nonzero(~ind)[0])
            else:
                groups.append(np.nonzero(ind ^ pre)[0])
            pre = ind.copy()

        if tmp.size == 1 or j >= nbits:
            ind = np.zeros(N, dtype=bool)
            ind[tmp] = True
            groups.append(np.nonzero(ind ^ pre)[0])
            groups.append(tmp)
            order = np.concatenate(groups[::-1])
            break

        curr = tmp
        Lists.append(curr)

    assert order is not None, "prelude failed to terminate"
    return Lists, Flags, weights, order


def parity_sqrt():
    """sqrt bit-compatible with the torch reference pipeline.

    The reference's torch pipeline ran on the CPU, and torch's CPU float64
    ``sqrt`` may miss the correctly rounded result in the last bit (on some
    hosts' vector paths); the butterfly constants ``a = sqrt(w0/(w0+w1))``
    inherit those ulps, which decide ``floor(x/step + 0.5)`` for
    coefficients on exact half-integer ties (integer colours make many).
    So this is torch's CPU sqrt on purpose, never ``ieee_sqrt`` or the
    card's."""

    def _sqrt(x: np.ndarray) -> np.ndarray:
        return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()

    return _sqrt


def raht_forward_lists(
    C: np.ndarray,
    Lists: TList[np.ndarray],
    Flags: TList[np.ndarray],
    weights: TList[np.ndarray],
    sqrt_fn=np.sqrt,
) -> Tuple[np.ndarray, np.ndarray]:
    """List-based forward RAHT (golden; matches ``RAHT.py:253-336``).

    ``sqrt_fn``: the square root used for the butterfly constants —
    ``np.sqrt`` (IEEE) by default, :func:`parity_sqrt` for bit-exact
    parity with the torch reference."""
    T = C.astype(np.float64).copy()
    N = T.shape[0]
    w = np.ones(N, dtype=np.float64)
    for j in range(len(Flags)):
        flag = Flags[j]
        right = np.concatenate([[False], flag[:-1]])
        i0 = Lists[j][flag]
        i1 = Lists[j][right]
        if i0.size == 0:
            continue
        w0 = weights[j][flag].astype(np.float64)
        w1 = weights[j][right].astype(np.float64)
        a = sqrt_fn(w0 / (w0 + w1))[:, None]
        b = sqrt_fn(w1 / (w0 + w1))[:, None]
        x0 = T[i0].copy()
        x1 = T[i1].copy()
        T[i0] = a * x0 + b * x1
        T[i1] = -b * x0 + a * x1
        combined = w[i0] + w[i1]
        w[i0] = combined
        w[i1] = combined
    return T, w


def raht_inverse_lists(
    T: np.ndarray,
    Lists: TList[np.ndarray],
    Flags: TList[np.ndarray],
    weights: TList[np.ndarray],
    sqrt_fn=np.sqrt,
) -> np.ndarray:
    """List-based inverse RAHT (golden; matches ``iRAHT.py:40-114``)."""
    C = T.astype(np.float64).copy()
    for j in reversed(range(len(Flags))):
        flag = Flags[j]
        right = np.concatenate([[False], flag[:-1]])
        i0 = Lists[j][flag]
        i1 = Lists[j][right]
        if i0.size == 0:
            continue
        w0 = weights[j][flag].astype(np.float64)
        w1 = weights[j][right].astype(np.float64)
        a = sqrt_fn(w0 / (w0 + w1))[:, None]
        b = sqrt_fn(w1 / (w0 + w1))[:, None]
        t0 = C[i0].copy()
        t1 = C[i1].copy()
        C[i0] = a * t0 - b * t1
        C[i1] = b * t0 + a * t1
    return C
