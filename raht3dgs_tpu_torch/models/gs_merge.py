"""Gaussian cluster merging as sorted segment sums.

Counterpart of ``raht3dgs_tpu/models/gs_merge.py``: members are sorted by
cluster id once and each run is reduced with
``ops/segment.py:sorted_segment_sums`` (no atomics, so the float sums have
one order on every device and in every run); each run's sums land in their
cluster's slot through one indexed assignment, which touches each real
slot once.

Merge semantics (the reference codec's merge kernel):
- member weight = opacity (``weight_by_opacity=True``) or 1;
- means/quats/scales/colors: weighted mean (total weight 0 -> zeros);
- quats: renormalized, a zero norm falls back to identity (0, 0, 0, 1);
- opacity: plain sum clamped to 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums
from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of


def merged_attributes(sums: torch.Tensor, C: int):
    """(means, quats, scales, opacities, colors) from per-cluster sums laid
    out as ``[w*means(3) | w*quats(4) | w*scales(3) | w*colors(C) | w |
    opacity]``."""
    tw = sums[:, 10 + C]
    tw_safe = torch.where(tw > 0, tw, torch.ones_like(tw))[:, None]
    m_means = sums[:, 0:3] / tw_safe
    q_acc = sums[:, 3:7]
    m_scales = sums[:, 7:10] / tw_safe
    m_colors = sums[:, 10:10 + C] / tw_safe
    q_norm = torch.linalg.norm(q_acc, dim=1, keepdim=True)
    identity = q_acc.new_tensor([0.0, 0.0, 0.0, 1.0])
    m_quats = torch.where(q_norm > 0,
                          q_acc / torch.where(q_norm > 0, q_norm, torch.ones_like(q_norm)),
                          identity[None, :])
    m_opac = torch.clamp_max(sums[:, 11 + C], 1.0)
    return m_means, m_quats, m_scales, m_opac, m_colors


def weighted_rows(means, quats, scales, opacities, colors,
                  weight_by_opacity: bool) -> torch.Tensor:
    """The (N, 12+C) rows whose per-cluster sums :func:`merged_attributes`
    reads."""
    w = (opacities if weight_by_opacity else torch.ones_like(opacities))[:, None]
    return torch.cat([w * means, w * quats, w * scales, w * colors, w,
                      opacities[:, None]], dim=1)


def merge_gaussian_clusters(
    means, quats, scales, opacities, colors, cluster_ids,
    num_clusters: int, weight_by_opacity: bool = True, *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, ...]:
    """Merge Gaussians sharing a cluster id; returns per-cluster (means,
    quats, scales, opacities, colors) with ``num_clusters`` rows (empty
    clusters: zeros, identity quats, opacity 0). Tensors stay on their
    device; host arrays go to ``device`` (CUDA unless ``device="cpu"``)."""
    dev = device_of(means, device)
    means, quats, scales, opacities, colors = (
        torch.as_tensor(x, device=dev) for x in (means, quats, scales, opacities, colors))
    ids = torch.as_tensor(cluster_ids, device=dev)
    N, C = means.shape[0], colors.shape[1]
    order = torch.argsort(ids, stable=True)
    cid_s = ids[order]
    vals = weighted_rows(means, quats, scales, opacities, colors, weight_by_opacity)[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), cid_s[1:] != cid_s[:-1]])
    sums, cid_rows, _, n_seg = sorted_segment_sums(vals, first,
                                                   cid_s[:, None].to(torch.float64))
    # run k's sums go to slot cid_rows[k]: runs have unique cluster ids, so
    # every real slot is written once; empty run slots all go to the extra
    # row num_clusters, which is dropped
    slot = torch.arange(N, device=dev)
    run_cid = torch.where(slot < n_seg, cid_rows[:, 0].to(torch.int64), num_clusters)
    out = sums.new_zeros((num_clusters + 1, sums.shape[1]))
    out[run_cid] = sums
    return merged_attributes(out[:num_clusters].to(means.dtype), C)


def prepare_cluster_data(cluster_labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR view of arbitrary cluster labels: ``(cluster_indices,
    cluster_offsets)``, member indices grouped by cluster and boundaries
    with ``offsets[k]..offsets[k+1]`` spanning cluster k."""
    labels = np.asarray(cluster_labels)
    _, inverse = np.unique(labels, return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    sorted_ids = inverse[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(sorted_ids))[0] + 1, [len(order)]])
    return order.astype(np.int32), boundaries.astype(np.int32)


def merge_gaussian_clusters_with_indices(
    means, quats, scales, opacities, colors,
    cluster_indices: np.ndarray, cluster_offsets: np.ndarray,
    weight_by_opacity: bool = True, *, device: DeviceLike = None,
):
    """CSR-input merge: the CSR form becomes per-row cluster ids (rows
    outside a partial CSR get the dropped slot ``k``) and goes through
    :func:`merge_gaussian_clusters`."""
    cluster_indices = np.asarray(cluster_indices)
    cluster_offsets = np.asarray(cluster_offsets)
    k = len(cluster_offsets) - 1
    member_cluster = np.repeat(np.arange(k), np.diff(cluster_offsets))
    ids = np.full(int(np.asarray(means).shape[0]), k, dtype=np.int64)
    ids[cluster_indices] = member_cluster
    return merge_gaussian_clusters(means, quats, scales, opacities, colors, ids,
                                   num_clusters=k, weight_by_opacity=weight_by_opacity,
                                   device=device)
