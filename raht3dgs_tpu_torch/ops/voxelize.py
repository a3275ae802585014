"""Morton-order voxelization with duplicate-voxel attribute merging.

Counterpart of ``raht3dgs_tpu/ops/voxelize.py``: shift by ``vmin``,
quantize by ``width / 2**depth`` with a clamp, sort by Morton code, find
the voxel boundaries and average the attributes of each voxel. Every
per-voxel output is padded to the input length N (zero counts and sentinel
codes after the ``nvox`` real voxels), as in the JAX package.

One stable sort of the codes gives the permutation, and one ``(N, 3+D)``
row gather applies it: bitwise the JAX package's result under either of
its sort modes. The per-voxel sums are scatter-free run reductions
(``ops/segment.py``, its default ``"shift"`` method); the voxel's code and
integer coordinates ride the same gather as exact float lanes, so no Morton
decode is needed.

At depth 21 the codes are the flipped int64 form of ``ops/morton.py``
(the JAX package's uint64 values with bit 63 flipped): ``morton_encode``
gives the real codes in it and ``pad_code`` the sentinels, so the two
meet in one dtype before the ``where`` (the JAX package's float64 trap:
mixing int64 and uint64 would round 63-bit codes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raht3dgs_tpu_torch.ops.morton import code_dtype, morton_encode, pad_code
from raht3dgs_tpu_torch.ops.raht import _code_lanes, _lanes_code
from raht3dgs_tpu_torch.ops.segment import sorted_segment_sums
from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of, to_device


class VoxelizeResult(NamedTuple):
    """Padded, Morton-sorted voxelization output (every shape static in N).

    Slots ``[0, nvox)`` of the per-voxel tensors are real voxels in
    ascending Morton order; slots ``[nvox, N)`` are padding with
    ``counts == 0`` and sentinel ``codes`` above every real code."""

    codes: torch.Tensor        # (N,) int32 (J <= 10) or int64 codes, flipped at J = 21 (pad: sentinels)
    positions: torch.Tensor    # (N, 3) integer voxel coords, the codes' dtype (pad: 0)
    attributes: torch.Tensor   # (N, D) per-voxel mean attributes (pad: 0)
    counts: torch.Tensor       # (N,) float — points per voxel (pad: 0)
    nvox: torch.Tensor         # () int32 — number of real voxels
    sort_idx: torch.Tensor     # (N,) int32 — permutation sorting points by code
    point_voxel: torch.Tensor  # (N,) int32 — voxel slot of each sorted point
    delta_pos: torch.Tensor    # (N, 3) float — sorted-point position residuals
    delta_attr: torch.Tensor   # (N, D) float — sorted-point attribute residuals
    voxel_size: torch.Tensor   # () float
    vmin: torch.Tensor         # (3,) float
    width: torch.Tensor        # () float


def _as_float(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``x`` rounded once to ``dtype``: host values pass through float64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(dev, dtype)


def voxelize(
    PC,
    depth: int,
    vmin=None,
    width=None,
    n_valid=None,
    *,
    device: DeviceLike = None,
) -> VoxelizeResult:
    """Voxelize a point cloud onto a ``2**depth`` cubic grid.

    Args:
        PC: ``(N, 3+D)`` float tensor or array — positions, then D attributes.
        depth: octree depth J.
        vmin: optional ``(3,)`` minimum corner; defaults to the per-axis min.
        width: optional bounding-box width; defaults to the largest extent.
        n_valid: optional number of valid leading rows; the rest are
            padding (they sort last and make pad voxels).
        device: where to run; a tensor's own device by default, CUDA for an
            array (``device="cpu"`` for the CPU).

    Returns:
        :class:`VoxelizeResult` with every tensor padded to length N.
    """
    dev = device_of(PC, device)
    PC = torch.as_tensor(PC, device=dev)
    N = PC.shape[0]
    D = PC.shape[1] - 3
    fdtype = PC.dtype
    V, C = PC[:, :3], PC[:, 3:]
    lim = (1 << depth) - 1

    row = torch.arange(N, dtype=torch.int32, device=dev)
    if n_valid is None:
        valid_in = torch.ones(N, dtype=torch.bool, device=dev)
    else:
        valid_in = row < torch.as_tensor(n_valid, device=dev).to(torch.int32)

    if vmin is None:
        vmin = torch.where(valid_in[:, None], V, torch.inf).amin(dim=0)
    else:
        vmin = _as_float(vmin, fdtype, dev)
    V0 = V - vmin[None, :]
    if width is None:
        width = torch.where(valid_in[:, None], V0, -torch.inf).max()
    else:
        width = _as_float(width, fdtype, dev)

    # float32 stays float32: the scale is a tensor op on the input dtype,
    # and the floor comes before the clamp and the cast, as in the JAX package.
    # A cloud of zero extent has voxel_size 0 and NaN coordinates here; XLA
    # casts NaN to the integer 0, PyTorch to INT_MIN, so NaN maps to 0 first
    voxel_size = width / to_device(2 ** depth, dev, fdtype)
    Vint = torch.clamp(torch.floor(V0 / voxel_size).nan_to_num(nan=0.0), 0, lim) \
        .to(torch.int32)
    cdt = code_dtype(depth, N)
    M = morton_encode(Vint, depth).to(cdt)
    # invalid input rows get sentinel codes, so they sort after every real code
    M = torch.where(valid_in, M, pad_code(depth, N, row))

    Ms, sort_idx = torch.sort(M, stable=True)
    PCs = torch.cat([V0, C], dim=1)[sort_idx]
    V0s, Cs = PCs[:, :3], PCs[:, 3:]
    # pads sort last, so the sorted validity mask is a prefix test
    valid_s = row < valid_in.sum()

    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), Ms[1:] != Ms[:-1]])
    point_voxel = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    nvox = (first & valid_s).sum().to(torch.int32)

    vals = torch.cat([torch.where(valid_s[:, None], Cs, 0),
                      valid_s.to(fdtype)[:, None]], dim=1)
    Vint_f = torch.floor(V0s / voxel_size)  # shared with `corner` below
    extra = torch.cat([_code_lanes(Ms, fdtype),
                       torch.clamp(Vint_f.nan_to_num(nan=0.0), 0, lim)], dim=1)
    sums, extra_rows, _, _ = sorted_segment_sums(vals, first, extra)
    counts = sums[:, D]
    Cvox = sums[:, :D] / torch.clamp_min(sums[:, D], 1.0)[:, None]

    real = row < nvox
    codes = torch.where(real, _lanes_code(extra_rows[:, :3], cdt), pad_code(depth, N, row))
    positions = torch.where(real[:, None], extra_rows[:, 3:].to(cdt), 0)
    counts = torch.where(real, counts, 0)
    Cvox = torch.where(real[:, None], Cvox, 0)

    corner = voxel_size * Vint_f
    delta_pos = torch.where(valid_s[:, None], V0s - corner, 0)
    delta_attr = torch.where(valid_s[:, None], Cs - Cvox[point_voxel.long()], 0)

    return VoxelizeResult(
        codes=codes, positions=positions, attributes=Cvox, counts=counts,
        nvox=nvox, sort_idx=sort_idx.to(torch.int32), point_voxel=point_voxel,
        delta_pos=delta_pos, delta_attr=delta_attr, voxel_size=voxel_size,
        vmin=vmin, width=width,
    )


def voxelize_pc(PC, param: dict, *, device: DeviceLike = None):
    """Legacy dict-parameter interface (the reference's ``voxelize_pc``):
    returns ``(PCvox, PCsorted, voxel_indices, DeltaPC)`` as numpy arrays of
    real (unpadded) shape, and with ``writeFileOut`` writes the voxelized
    cloud (``<filename>_vox.ply``) and its metadata (``<filename>_data.txt``).

    ``param`` keys: ``J`` (required), ``vmin``, ``width``,
    ``writeFileOut``, ``filename``.
    """
    depth = param["J"]
    res = voxelize(PC, depth, vmin=param.get("vmin"), width=param.get("width"),
                   device=device)
    nvox = int(res.nvox)
    n = PC.shape[0]

    pos = res.positions[:nvox].cpu().numpy().astype(float)
    attrs = res.attributes[:nvox].cpu().numpy()
    PCvox = np.concatenate([pos, attrs], axis=1) if attrs.size else pos
    PCsorted = np.asarray(PC)[res.sort_idx.cpu().numpy()]
    first = res.point_voxel.cpu().numpy()
    voxel_indices = np.concatenate([[0], np.nonzero(np.diff(first))[0] + 1])
    DeltaPC = np.concatenate([res.delta_pos.cpu().numpy(),
                              res.delta_attr.cpu().numpy()], axis=1)

    if param.get("writeFileOut"):
        filename = param.get("filename")
        if not filename:
            raise ValueError("'filename' required when writeFileOut=True")
        from raht3dgs_tpu_torch.io.ply import save_ply_ascii

        vs = float(res.voxel_size)
        vmin_used = res.vmin.cpu().numpy()
        centers = (pos + 0.5) * vs + vmin_used
        colors = attrs[:, :3] if attrs.shape[1] >= 3 else None
        if colors is not None:
            # the writer's uchar columns take 0..255: the reference scales
            # to [0, 1] when max > 1 and its PLY layer scales back
            c01 = colors / 255.0 if colors.size and colors.max() > 1.0 else colors
            colors = np.clip(np.round(c01 * 255.0), 0, 255)
        save_ply_ascii(f"{filename}_vox.ply", centers, colors)
        with open(f"{filename}_data.txt", "w") as f:
            f.write(
                f"{vmin_used[0]} {vmin_used[1]} {vmin_used[2]} "
                f"{float(res.width)} {depth} {nvox} {n} "
                f"{int(attrs.shape[1] > 0)}\n"
            )
            np.savetxt(f, voxel_indices, fmt="%d")
            np.savetxt(f, DeltaPC, fmt="%.6f")

    return PCvox, PCsorted, voxel_indices, DeltaPC
