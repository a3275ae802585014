"""Plain 3DGS voxelization and merge of the benchmark's reference.

The semantics of ``raht3dgs_tpu_torch/models/gs_voxelize.py:compress_to_nvox``
(the reference codec's ``compress_to_nvox``, ``python/test_voxelize_3dgs.py:
160``), rewritten in plain torch on the host:

- voxelize the means: ``vmin`` the per-axis minimum, ``width`` the largest
  extent, ``voxel_size = width / 2**J`` and the voxel
  ``clamp(floor((m - vmin) / voxel_size), 0, 2**J - 1)``
  (``ops/voxelize.py:104-117``);
- merge each voxel's Gaussians (``models/gs_merge.py:1-14``): weight the
  opacity; means, quats, scales and colours the weighted mean (total
  weight 0: zeros), quats renormalized (a zero norm: identity
  ``(0, 0, 0, 1)``), opacity the plain sum clamped to 1.

:func:`voxel_gap` judges the program's voxel of each Gaussian against the
float64 coordinate; :func:`merge` then follows the program's assignment
(a Gaussian within rounding of a voxel face may fall either side), so the
merged attributes are compared voxel by voxel. Imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def voxel_coords(means: np.ndarray, depth: int, dtype=torch.float64):
    """``(u (n, 3) float64 coordinates in voxel units, vmin, voxel_size)``
    computed in ``dtype``."""
    m = torch.from_numpy(np.asarray(means)).to(dtype)
    vmin = m.min(dim=0).values
    m0 = m - vmin
    width = m0.max()
    vs = width / torch.tensor(float(1 << depth), dtype=dtype)
    u = m0 / vs
    return u.double().numpy(), vmin.double().numpy(), float(vs)


def voxel_gap(means: np.ndarray, depth: int, positions: np.ndarray, cluster: np.ndarray,
              n_voxels: int, vmin: np.ndarray, voxel_size: float) -> float:
    """In voxel units, how far the float64 coordinate of a Gaussian lies
    outside the voxel the program put it in, worst over the scene; also
    the program's ``vmin`` and ``voxel_size`` against the reference's in
    voxel units. Inf when a voxel has no member or voxels repeat."""
    u, vmin_r, vs_r = voxel_coords(means, depth)
    cluster = np.asarray(cluster, np.int64)
    if cluster.min() < 0 or cluster.max() >= n_voxels:
        return float("inf")
    P = np.asarray(positions[:n_voxels], np.int64)
    if np.bincount(cluster, minlength=n_voxels).min() == 0:
        return float("inf")
    if len(np.unique(P, axis=0)) != n_voxels:
        return float("inf")
    Pi = P[cluster].astype(np.float64)
    gap = np.maximum(np.maximum(Pi - u, u - (Pi + 1.0)), 0.0).max()
    meta = max(np.abs(np.asarray(vmin, np.float64) - vmin_r).max() / vs_r,
               abs(voxel_size - vs_r) / vs_r * (1 << depth))
    return float(max(gap, meta))


def merge(scene: Dict[str, np.ndarray], cluster: np.ndarray, n_voxels: int,
          dtype=torch.float64) -> np.ndarray:
    """The merged ``(n_voxels, 8 + C)`` payload ``[quats, scales, opacity,
    colors]`` of the Gaussians grouped by ``cluster``, summed in
    ``dtype``."""
    idx = torch.from_numpy(np.asarray(cluster, np.int64))
    t = {k: torch.from_numpy(np.asarray(v)).to(dtype) for k, v in scene.items()}
    w = t["opacities"][:, None]
    rows = torch.cat([w * t["quats"], w * t["scales"], w * t["colors"], w,
                      t["opacities"][:, None]], dim=1)
    sums = torch.zeros(n_voxels, rows.shape[1], dtype=dtype).index_add_(0, idx, rows)
    C = t["colors"].shape[1]
    tw = sums[:, 7 + C]
    tw = torch.where(tw > 0, tw, torch.ones_like(tw))[:, None]
    q = sums[:, 0:4]
    qn = torch.linalg.norm(q, dim=1, keepdim=True)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    quats = torch.where(qn > 0, q / torch.where(qn > 0, qn, torch.ones_like(qn)), ident)
    scales = sums[:, 4:7] / tw
    colors = sums[:, 7:7 + C] / tw
    opac = torch.clamp(sums[:, 8 + C], max=1.0)[:, None]
    return torch.cat([quats, scales, opac, colors], dim=1).double().numpy()


GROUPS: Tuple[Tuple[int, int], ...] = ((0, 4), (4, 7), (7, 8), (8, None))


def merge_err(program: np.ndarray, reference: np.ndarray) -> float:
    """Largest difference of a merged attribute, over its group's largest
    magnitude in the reference (quats, scales, opacity, colours)."""
    worst = 0.0
    for lo, hi in GROUPS:
        r = reference[:, lo:hi]
        d = np.abs(np.asarray(program, np.float64)[:, lo:hi] - r).max()
        worst = max(worst, d / max(np.abs(r).max(), 1e-30))
    return float(worst)
