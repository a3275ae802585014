"""Bitrate estimate of quantized coefficients, on their device.

Counterpart of ``raht3dgs_tpu/ops/rate_model.py``: a block-adaptive
Golomb-Rice surrogate of the RLGR coder's size, so a rate search can
price a quantization step without a host entropy encode:

- zigzag-map the symbols (int64);
- per block of 256 rows and per channel, the cheaper of two costs: every
  symbol a GR codeword under the best ``k`` (``(u >> k) + 1 + k`` bits),
  or run mode (about one bit a run of zeros, each nonzero its partial-run
  length and ``GR(u - 1)``), with an all-zero block floored at 8 bits;
- the per-channel sum over blocks, in float64.

The JAX package writes the costs over every ``k`` as one ``(K, nb, B, D)``
broadcast, which XLA fuses. Eager PyTorch would materialise it (4.2 GB
for a 2^19-row 56-channel frame, twice), so here ``k`` is a loop with a
running minimum, and :func:`estimate_bpp_grid` walks a grid of steps in
chunks of at most ``CHUNK_ELEMS`` symbols (of steps, then of channels).
Every cost is an integer below 2^53 until the run-mode terms, so the sums
equal the JAX package's up to the order of the last float64 reductions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from raht3dgs_tpu_torch.ops.quantize import quantize

BLOCK = 256
MAX_K = 18
# symbols in one chunk of the step grid: a chunk's int64 temporaries take
# about 40 bytes a symbol, so ~340 MB of device memory at this size
CHUNK_ELEMS = 1 << 23
_LN2 = math.log(2.0)


def _zigzag(q: torch.Tensor) -> torch.Tensor:
    q = q.to(torch.int64)
    return torch.where(q >= 0, 2 * q, -2 * q - 1)


def _block_mask(valid, n: int, block: int, device) -> torch.Tensor:
    """(nb, block, 1) float64 row mask: ``valid`` (all rows when None),
    zero on the rows that pad ``n`` up to whole blocks."""
    if valid is None:
        vc = torch.ones(n, dtype=torch.float64, device=device)
    else:
        vc = torch.as_tensor(valid, device=device).to(torch.float64)
    vc = F.pad(vc, (0, (-n) % block))
    return vc.reshape(-1, block, 1)


def _blocked_symbols(q: torch.Tensor, valid, block: int) -> torch.Tensor:
    """(..., N, D) symbols -> (..., nb, block, D) int64 zigzag symbols, zero
    outside ``valid`` and on the padding rows."""
    u = _zigzag(q)
    if valid is not None:
        u = torch.where(torch.as_tensor(valid, device=q.device)[:, None], u, 0)
    n, d = u.shape[-2:]
    u = F.pad(u, (0, 0, 0, (-n) % block))
    return u.reshape(*u.shape[:-2], -1, block, d)


def _channel_bits(ub: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Estimated bits of each channel: ``ub`` (..., nb, B, D) int64 zigzag
    symbols (zero wherever ``vb`` is), ``vb`` (nb, B, 1) float64 mask.
    Returns (..., D) float64."""
    nval = vb.sum(-2)                                    # (nb, 1)
    nnz = (ub > 0).sum(-2).to(torch.float64)             # (..., nb, D)
    zeros = torch.clamp_min(nval - nnz, 0.0)
    # no-run mode: every symbol a GR codeword under the best k; run mode:
    # each nonzero costs GR(u - 1) under the best k. k walks 0..MAX_K-1 by
    # shifting one copy of each in place, keeping the running minimum.
    shifted = ub.clone()
    shifted1 = torch.clamp_min(ub - 1, 0)
    cost_gr = val_bits = None
    for k in range(MAX_K):
        if k:
            shifted >>= 1
            shifted1 >>= 1
        per_k = shifted.sum(-2).to(torch.float64) + nval * (1 + k)
        val_k = shifted1.sum(-2).to(torch.float64) + nnz * (1 + k)
        cost_gr = per_k if k == 0 else torch.minimum(cost_gr, per_k)
        val_bits = val_k if k == 0 else torch.minimum(val_bits, val_k)
    del shifted, shifted1
    run_len = zeros / torch.clamp_min(nnz, 1.0)
    # log2 as log / log(2), the JAX package's jnp.log2
    run_bits = nnz * (1.0 + torch.log(run_len + 2.0) / _LN2) + zeros / torch.clamp_min(
        run_len, 1.0)
    cost_run = torch.where(nnz > 0, val_bits + run_bits, 8.0)
    return torch.minimum(cost_gr, cost_run).sum(-2)


def estimate_rlgr_bits(q: torch.Tensor, valid=None, block: int = BLOCK) -> torch.Tensor:
    """Estimated bits to RLGR-encode each channel of ``q`` (N, D) int32.

    ``valid``: optional (N,) bool mask (padding exclusion). Returns (D,)
    float64 bit counts, on ``q``'s device."""
    n = q.shape[0]
    return _channel_bits(_blocked_symbols(q, valid, block),
                         _block_mask(valid, n, block, q.device))


def estimate_bpp(q: torch.Tensor, n_voxels: int, valid=None) -> torch.Tensor:
    """Estimated total rate in bits per voxel over all channels."""
    return estimate_rlgr_bits(q, valid=valid).sum() / n_voxels


def estimate_bpp_grid(coeffs: torch.Tensor, steps_grid: torch.Tensor, valid,
                      n_voxels: int) -> torch.Tensor:
    """``estimate_bpp(quantize(coeffs, st), n_voxels, valid)`` for every row
    ``st`` of the (S, D') step grid (D' = 1 or D), as one (S,) float64
    tensor. Steps are walked in chunks of about ``CHUNK_ELEMS`` symbols;
    a step wider than that is split by channels (each channel's estimate
    is independent of the others)."""
    n, d = coeffs.shape
    steps_grid = torch.as_tensor(steps_grid, device=coeffs.device)
    S = steps_grid.shape[0]
    vb = _block_mask(valid, n, BLOCK, coeffs.device)
    per_step = n * d
    s_chunk = max(1, CHUNK_ELEMS // per_step)
    d_chunk = d if per_step <= CHUNK_ELEMS else max(1, CHUNK_ELEMS // n)
    bits = torch.empty((S, d), dtype=torch.float64, device=coeffs.device)
    for s0 in range(0, S, s_chunk):
        st = steps_grid[s0:s0 + s_chunk]
        for d0 in range(0, d, d_chunk):
            stc = st if st.shape[1] == 1 else st[:, d0:d0 + d_chunk]
            q = quantize(coeffs[None, :, d0:d0 + d_chunk], stc[:, None, :])
            bits[s0:s0 + s_chunk, d0:d0 + d_chunk] = _channel_bits(
                _blocked_symbols(q, valid, BLOCK), vb)
            del q
    return bits.sum(1) / n_voxels
