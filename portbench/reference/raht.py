"""Plain RAHT of the benchmark's reference: Morton codes, the ragged
prelude with its RA-GFT order, and the list-based forward and inverse
transforms, in any torch floating dtype on the host.

Frozen copies, so that the yardstick stays fixed while the program
changes:

- :func:`morton_codes` is ``raht3dgs_tpu_torch/ops/morton.py:124``
  (``morton_codes_np``): x takes the most significant bit of each triple.
- :func:`prelude` is ``raht3dgs_tpu_torch/ops/prelude.py:25``, the
  reference codec's ``RAHT_param_reorder_fast`` (``RAHT_param.py:191-279``):
  per-level group starts, sibling flags, run lengths and the RA-GFT order.
- :func:`forward` and :func:`inverse` are ``ops/prelude.py:103,139``
  (``RAHT.py:253-336``, ``iRAHT.py:40-114``), rewritten over torch tensors
  so that one body serves the float64 reference and the lower-precision
  control (``dtype=torch.bfloat16``).

Imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def morton_codes(V: np.ndarray, depth: int) -> np.ndarray:
    """int64 Morton codes of integer coordinates ``V (n, 3)``."""
    V = np.asarray(V).astype(np.int64)
    M = np.zeros(V.shape[0], dtype=np.int64)
    for i in range(depth):
        b = (V >> i) & 1
        M |= (b[:, 2] + (b[:, 1] << 1) + (b[:, 0] << 2)) << (3 * i)
    return M


def prelude(codes: np.ndarray, nbits: int) -> Tuple[List[np.ndarray], List[np.ndarray],
                                                    List[np.ndarray], np.ndarray]:
    """Per-level ``lists / flags / weights`` and the 0-based RA-GFT order of
    Morton-sorted unique ``codes``."""
    N = codes.shape[0]
    if N == 1:
        return ([np.zeros(1, np.int64)], [np.array([False])], [np.ones(1, np.int64)],
                np.zeros(1, np.int64))
    curr = np.arange(N, dtype=np.int64)
    lists, flags, weights, groups = [curr], [], [], []
    pre = np.zeros(N, dtype=bool)
    order = None
    for j in range(1, 65):
        nxt = np.append(curr[1:], N)
        weights.append((nxt - curr).astype(np.int64))
        Mj = codes[curr]
        if Mj.size == 1:
            flags.append(np.array([False]))
            break
        mask = np.int64((1 << nbits) - (1 << j))
        flag = np.append(((Mj[:-1] ^ Mj[1:]) & mask) == 0, False)
        flags.append(flag)
        prev = np.concatenate([[False], flag[:-1]])
        tmp = curr[~prev]
        if j % 3 == 0 and j > 2:
            ind = np.zeros(N, dtype=bool)
            ind[tmp] = True
            groups.append(np.nonzero(~ind)[0] if j == 3 else np.nonzero(ind ^ pre)[0])
            pre = ind.copy()
        if tmp.size == 1 or j >= nbits:
            ind = np.zeros(N, dtype=bool)
            ind[tmp] = True
            groups.append(np.nonzero(ind ^ pre)[0])
            groups.append(tmp)
            order = np.concatenate(groups[::-1])
            break
        curr = tmp
        lists.append(curr)
    if order is None:
        raise RuntimeError("the prelude did not terminate")
    return lists, flags, weights, order


def _pairs(pre, j: int, dtype):
    lists, flags, weights, _ = pre
    flag = flags[j]
    right = np.concatenate([[False], flag[:-1]])
    i0 = torch.from_numpy(lists[j][flag])
    i1 = torch.from_numpy(lists[j][right])
    w0 = torch.from_numpy(weights[j][flag]).to(torch.float64)
    w1 = torch.from_numpy(weights[j][right]).to(torch.float64)
    # the butterfly constants in the transform's own precision
    a = torch.sqrt((w0 / (w0 + w1)).to(dtype))[:, None]
    b = torch.sqrt((w1 / (w0 + w1)).to(dtype))[:, None]
    return i0, i1, a, b


def forward(C: torch.Tensor, pre, dtype=torch.float64) -> torch.Tensor:
    """Forward RAHT of the rows ``C (N, D)`` (Morton order), in ``dtype``."""
    T = C.to(dtype).clone()
    for j in range(len(pre[1])):
        i0, i1, a, b = _pairs(pre, j, dtype)
        if i0.numel() == 0:
            continue
        x0, x1 = T[i0], T[i1]
        T[i0] = a * x0 + b * x1
        T[i1] = -b * x0 + a * x1
    return T


def inverse(T: torch.Tensor, pre, dtype=torch.float64) -> torch.Tensor:
    """Inverse of :func:`forward`, in ``dtype``."""
    C = T.to(dtype).clone()
    for j in reversed(range(len(pre[1]))):
        i0, i1, a, b = _pairs(pre, j, dtype)
        if i0.numel() == 0:
            continue
        t0, t1 = C[i0], C[i1]
        C[i0] = a * t0 - b * t1
        C[i1] = b * t0 + a * t1
    return C
