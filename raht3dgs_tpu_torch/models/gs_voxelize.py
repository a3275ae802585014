"""3DGS N -> Nvox compression: voxelize the Gaussian means, merge per voxel.

Counterpart of ``raht3dgs_tpu/models/gs_voxelize.py`` (the reference
codec's ``compress_to_nvox`` script): voxelize the means at depth J, merge
the Gaussians of each voxel (opacity-weighted) and optionally save the
original and compressed PLYs with voxel metadata. Voxelize and merge run
on one device with no host round trip: one wide ``(N, 11+C)`` row gather
applies the voxelizer's sort, one ``(N, 12+C)`` matrix of weighted rows
goes through the segment sums, and the inverse permutation is an argsort
gather rather than a scatter. The result reaches the host only when
:func:`compress_to_nvox` hands out numpy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from raht3dgs_tpu_torch.io.ply import save_ply_3dgs
from raht3dgs_tpu_torch.models.gs_merge import merged_attributes, weighted_rows
from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums
from raht3dgs_tpu_torch.ops.voxelize import voxelize
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device
from raht3dgs_tpu_torch.utils.timing import StageTimer

GS_KEYS = ("means", "quats", "scales", "opacities", "colors")


@dataclass
class CompressedGaussians:
    """Padded voxelized scene; real voxels occupy slots ``[0, n_voxels)``."""

    positions_int: np.ndarray   # (Np, 3) integer voxel coords
    quats: np.ndarray           # (Np, 4)
    scales: np.ndarray          # (Np, 3)
    opacities: np.ndarray       # (Np,)
    colors: np.ndarray          # (Np, C)
    means_world: np.ndarray     # (Np, 3) merged world-space means
    n_voxels: int
    n_input: int
    voxel_size: float
    vmin: np.ndarray
    width: float
    cluster_of_input: np.ndarray  # (N,) voxel slot of each input Gaussian
    timer: StageTimer


def merge_rows(means, quats, scales, opacities, colors, depth: int,
               weight_by_opacity: bool = True):
    """The voxelization of the means, and the (N, 12+C) weighted rows of
    :func:`~raht3dgs_tpu_torch.models.gs_merge.weighted_rows` in its sorted
    order with the first row of each voxel flagged: ``(vox, rows, first)``."""
    C = colors.shape[1]
    vox = voxelize(means, depth)
    # one wide row gather instead of five with the same indices
    packed = torch.cat([quats, scales, opacities[:, None], colors, means],
                       dim=1)[vox.sort_idx.long()]
    rows = weighted_rows(packed[:, 8 + C:], packed[:, 0:4], packed[:, 4:7], packed[:, 7],
                         packed[:, 8:8 + C], weight_by_opacity)
    pv = vox.point_voxel
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pv.device), pv[1:] != pv[:-1]])
    return vox, rows, first


def voxelize_merge(means, quats, scales, opacities, colors, depth: int,
                   weight_by_opacity: bool = True):
    """Voxelize + per-voxel Gaussian merge of device tensors, padded to N
    slots. Returns (positions, quats, scales, opacities, colors, means,
    nvox, voxel_size, vmin, width, cluster_of_input) as tensors."""
    vox, rows, first = merge_rows(means, quats, scales, opacities, colors, depth,
                                  weight_by_opacity)
    sums, _, _, _ = sorted_segment_sums(rows, first)
    m_means, m_quats, m_scales, m_opac, m_colors = merged_attributes(
        sums.to(means.dtype), colors.shape[1])
    # each input Gaussian's voxel, in input order: a gather through the
    # inverse permutation (argsort), no scatter
    cluster_of_input = vox.point_voxel[torch.argsort(vox.sort_idx.long())]
    return (vox.positions, m_quats, m_scales, m_opac, m_colors, m_means,
            vox.nvox, vox.voxel_size, vox.vmin, vox.width, cluster_of_input)


def compress_to_nvox(
    params: Dict[str, np.ndarray],
    depth: int = 10,
    weight_by_opacity: bool = True,
    output_dir: Optional[str] = None,
    *,
    device: DeviceLike = None,
) -> CompressedGaussians:
    """Voxelize + merge a 3DGS scene in float32 on CUDA (unless
    ``device="cpu"``).

    ``params``: dict of numpy means/quats/scales/opacities/colors (from
    ``io.gsplat_ckpt.load_gsplat_checkpoint`` or a PLY). With
    ``output_dir``, writes ``original_N_gaussians.ply`` and
    ``compressed_Nvox_gaussians.ply`` (integer voxel positions + metadata),
    the file that ``encode_3dgs`` reads."""
    dev = resolve_device(device)
    timer = StageTimer()
    args = [torch.as_tensor(np.asarray(params[k], dtype=np.float32), device=dev)
            for k in GS_KEYS]
    out = timer.time("voxelize_merge", voxelize_merge, *args, depth, weight_by_opacity)
    (pos, quats, scales, opac, colors, means_w, nvox, voxel_size, vmin,
     width, cluster) = [t.cpu().numpy() for t in out]
    nvox = int(nvox)

    result = CompressedGaussians(
        positions_int=pos, quats=quats, scales=scales, opacities=opac,
        colors=colors, means_world=means_w, n_voxels=nvox,
        n_input=len(params["means"]), voxel_size=float(voxel_size), vmin=vmin,
        width=float(width), cluster_of_input=cluster, timer=timer,
    )
    if output_dir is not None:
        t0 = time.perf_counter()
        outp = Path(output_dir)
        outp.mkdir(parents=True, exist_ok=True)
        save_ply_3dgs(outp / "original_N_gaussians.ply", *(params[k] for k in GS_KEYS))
        r = slice(0, nvox)
        save_ply_3dgs(
            outp / "compressed_Nvox_gaussians.ply",
            result.positions_int[r].astype(np.float32), result.quats[r],
            result.scales[r], result.opacities[r], result.colors[r],
            voxel_size=result.voxel_size, vmin=result.vmin,
        )
        timer.add("save_ply", time.perf_counter() - t0)
    return result


def world_positions(c: CompressedGaussians) -> np.ndarray:
    """Voxel centres in world space: ``(V + 0.5) * voxel_size + vmin``."""
    r = slice(0, c.n_voxels)
    return (c.positions_int[r] + 0.5) * c.voxel_size + c.vmin
