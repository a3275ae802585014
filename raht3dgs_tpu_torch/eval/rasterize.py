"""Volumetric 3D Gaussian Splatting rasterizer in PyTorch.

Counterpart of ``raht3dgs_tpu/eval/rasterize.py``: the same image
formation model (gsplat parity) as plain PyTorch ops on the caller's
device, CUDA unless ``device="cpu"``. The JAX module is plain XLA (no
Pallas kernel), so this one is plain PyTorch too:

- **Projection (EWA splatting).** ``Sigma = R S S^T R^T`` from the unit
  quaternion and per-axis scales, camera-space mean ``t = W p + c``,
  perspective Jacobian ``J`` with gsplat's 1.3x tangent-plane clamp,
  ``Sigma' = J W Sigma W^T J^T + 0.3 I`` (``antialiased=False`` parity).
- **Spherical harmonics** to degree 3 along the camera->Gaussian
  direction, ``rgb = max(SH(dir) + 0.5, 0)``.
- **Tile binning.** One stable depth sort, a static ``(N, M)`` grid of
  (tile, Gaussian) entries over each footprint's tile box, the exact-zero
  cull (:func:`_cull_mask`), optional compaction to the post-cull width,
  and one sort of int64 keys ``(tile << rank_bits) | depth_rank``. The
  keys are unique and non-negative, so every per-tile segment is the JAX
  package's, whichever of its two sorts it took; ``searchsorted`` gives
  the windows.
- **Front-to-back blend with an exact early exit.** Tiles in order of
  occupancy, processed in bands of shrinking width (T, T/4, T/16, ...),
  each band a Python loop over chunks of ``chunk`` entries whose
  saturation test is read on the host once per chunk (one device sync a
  chunk, counted in :data:`COUNTS`); a chunk blends only the prefix of
  tiles with entries left, known on the host from one read of the
  occupancies. Within a chunk the transmittance is an exclusive
  ``cumprod`` and the colour sum a ``cumsum`` along the chunk, both along
  the innermost axis, so a tile's arithmetic does not depend on how many
  tiles run beside it: stopping once every tile is exhausted or its
  transmittance has underflowed to 0.0 gives the bits of running every
  chunk (``early_exit=False``).

Exactness: away from the capacity limits (``max_tiles_per_gauss``,
``max_per_tile``; overflows are counted in :class:`RasterMeta`, never
silent) the tiled image equals :func:`rasterize_dense` to float32
rounding. Float-to-int casts of tile and pixel indices clamp in float
first and map NaN to 0, XLA's conversion, so a Gaussian of infinite
radius or a NaN mean bins as in the JAX package on every device.

``RAHT3DGS_RASTER_CULL=0`` turns the cull off and
``RAHT3DGS_RASTER_COMPACT=0`` the compaction (both on by default), read at
each call.
"""

from __future__ import annotations

import bisect
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.utils.device import DeviceLike, device_of

# 3DGS spherical-harmonics basis constants (degrees 0-3).
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

_ALPHA_MIN = 1.0 / 255.0   # contribution cutoff (gsplat parity)
_ALPHA_MAX = 0.999         # alpha clamp (gsplat parity)
_NEAR_PLANE = 0.01         # near-plane cull (gsplat default)

# What the rasterizer did since the last reset_counts(): views rendered by
# _rasterize_tiled, blend chunks executed, and host reads of device values
# (one per chunk condition, per capacity probe and per image copy).
COUNTS = {"views": 0, "chunks": 0, "syncs": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


class RasterMeta(NamedTuple):
    """Capacity diagnostics for one rasterized view (device scalars).

    ``dup_clipped``: tile-footprint entries dropped because a Gaussian
    covered more than ``max_tiles_per_gauss`` tiles.
    ``tile_clipped``: entries dropped because a tile held more than
    ``max_per_tile`` Gaussians. Both zero => the image is the dense blend
    (see :func:`rasterize_dense`)."""

    dup_clipped: torch.Tensor
    tile_clipped: torch.Tensor


def eval_sh(colors: torch.Tensor, dirs: torch.Tensor, sh_degree: int) -> torch.Tensor:
    """Evaluate SH colors (N, K, 3) along unit directions (N, 3).

    Standard 3DGS convention: ``rgb = clamp(SH(dir) + 0.5, min=0)``.
    ``sh_degree`` in [0, 3]; K must be >= (sh_degree + 1)**2.
    """
    x = dirs[:, 0:1]
    y = dirs[:, 1:2]
    z = dirs[:, 2:3]
    res = _SH_C0 * colors[:, 0]
    if sh_degree >= 1:
        res = (
            res
            - _SH_C1 * y * colors[:, 1]
            + _SH_C1 * z * colors[:, 2]
            - _SH_C1 * x * colors[:, 3]
        )
    if sh_degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        res = (
            res
            + _SH_C2[0] * xy * colors[:, 4]
            + _SH_C2[1] * yz * colors[:, 5]
            + _SH_C2[2] * (2.0 * zz - xx - yy) * colors[:, 6]
            + _SH_C2[3] * xz * colors[:, 7]
            + _SH_C2[4] * (xx - yy) * colors[:, 8]
        )
    if sh_degree >= 3:
        res = (
            res
            + _SH_C3[0] * y * (3.0 * xx - yy) * colors[:, 9]
            + _SH_C3[1] * xy * z * colors[:, 10]
            + _SH_C3[2] * y * (4.0 * zz - xx - yy) * colors[:, 11]
            + _SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * colors[:, 12]
            + _SH_C3[4] * x * (4.0 * zz - xx - yy) * colors[:, 13]
            + _SH_C3[5] * z * (xx - yy) * colors[:, 14]
            + _SH_C3[6] * x * (xx - 3.0 * yy) * colors[:, 15]
        )
    return torch.clamp(res + 0.5, min=0.0)


def _quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Unit-normalized quaternions (N, 4) wxyz -> rotation matrices (N, 3, 3).

    Zero-norm quaternions fall back to identity (the cluster-merge
    convention, ``models/gs_merge.py``)."""
    norm = torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    safe = norm > 1e-12
    q = torch.where(safe, quats / torch.where(safe, norm, torch.ones_like(norm)),
                    quats.new_tensor([1.0, 0.0, 0.0, 0.0])[None, :])
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        dim=1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        dim=1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                        dim=1),
        ],
        dim=1,
    )


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., m, 3) and ``b`` (..., 3, n), broadcasting,
    as three products added left to right in separate ops: the same bits
    on the CPU and the card (a library matrix product may fuse or reorder
    them), so the depths, and the depth order, agree between the two."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def project_gaussians(means, quats, scales, opacities, viewmat, Kmat, width: int,
                      height: int, eps2d: float = 0.3):
    """EWA projection of 3D Gaussians to 2D screen-space splats.

    Returns (means2d (N,2), conics (N,3) = (A, B, C) of the inverse 2D
    covariance [A B; B C], depths (N,), radii (N,), alive mask (N,),
    viewdirs (N,3) camera->Gaussian unit directions in world space,
    lam1 (N,) larger eigenvalue of the dilated 2D covariance)."""
    R_w2c = viewmat[:3, :3]
    t_w2c = viewmat[:3, 3]
    cam = _matmul3(means, R_w2c.T) + t_w2c[None, :]
    depths = cam[:, 2]
    alive = depths > _NEAR_PLANE
    zs = torch.where(alive, depths, torch.ones_like(depths))

    fx, fy = Kmat[0, 0], Kmat[1, 1]
    cx, cy = Kmat[0, 2], Kmat[1, 2]
    mx = fx * cam[:, 0] / zs + cx
    my = fy * cam[:, 1] / zs + cy

    # 3D covariance Sigma = R S S^T R^T, then camera frame M = W Sigma W^T
    Rg = _quat_to_rotmat(quats)
    RS = Rg * scales[:, None, :]  # columns scaled
    Sigma = _matmul3(RS, RS.transpose(1, 2))
    M = _matmul3(_matmul3(R_w2c, Sigma), R_w2c.T)

    # perspective Jacobian J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]],
    # the tangent-plane offsets clamped as gsplat does (off-screen splats only)
    lim_x = 1.3 * (width / 2.0) / fx
    lim_y = 1.3 * (height / 2.0) / fy
    tx = zs * torch.clamp(cam[:, 0] / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(cam[:, 1] / zs, -lim_y, lim_y)
    z2 = zs * zs
    zero = torch.zeros_like(zs)
    J = torch.stack(
        [
            torch.stack([fx / zs, zero, -fx * tx / z2], dim=1),
            torch.stack([zero, fy / zs, -fy * ty / z2], dim=1),
        ],
        dim=1,
    )
    cov2 = _matmul3(_matmul3(J, M), J.transpose(1, 2))
    a = cov2[:, 0, 0] + eps2d
    c = cov2[:, 1, 1] + eps2d
    b = cov2[:, 0, 1]

    det = a * c - b * b
    alive &= det > 0
    det_s = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], dim=1)

    # 3-sigma footprint radius from the larger eigenvalue
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    alive &= radii > 0
    # cull footprints entirely outside the image
    alive &= (mx + radii > 0) & (mx - radii < width)
    alive &= (my + radii > 0) & (my - radii < height)
    alive &= opacities > 0.0

    cam_pos = _matmul3(-R_w2c.T, t_w2c[:, None])[:, 0]
    vd = means - cam_pos[None, :]
    vd = vd / torch.clamp(torch.linalg.vector_norm(vd, dim=1, keepdim=True), min=1e-12)
    means2d = torch.stack([mx, my], dim=1)
    return means2d, conic, depths, radii, alive, vd, lam1


def _colors_to_sh(colors: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(N, 3K) or (N, K, 3) SH colors -> ((N, K, 3), inferred degree)."""
    if colors.ndim == 2:
        if colors.shape[1] % 3 != 0:
            raise ValueError(f"color channels {colors.shape[1]} not a multiple of 3")
        colors = colors.reshape(colors.shape[0], -1, 3)
    K = colors.shape[1]
    degree = int(np.sqrt(K)) - 1
    if (degree + 1) ** 2 != K or not 0 <= degree <= 3:
        raise ValueError(f"{K} SH coefficients is not a supported degree (0-3)")
    return colors, degree


def _floor_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """``floor(v)`` as int32 with XLA's conversion of what does not fit:
    NaN -> 0, and everything else clamped in float to ``[-1, n]`` first
    (the float-to-int cast of inf, NaN or an out-of-range value differs
    between torch's CPU and CUDA), so every finite value within it keeps
    its integer and each side of ``[0, n)`` stays on its side."""
    f = torch.nan_to_num(torch.floor(v), nan=0.0, posinf=float(n), neginf=-1.0)
    return torch.clamp(f, -1.0, float(n)).to(torch.int32)


def _tile_bbox(mx, my, r, tile, tiles_x, tiles_y):
    """Tile-footprint bounding box of each Gaussian (clipped to the grid).

    THE bbox formula: the binning pass, the dense golden's membership
    cutoff and the auto tile budget all call this one definition."""
    tx0 = torch.clamp(_floor_index((mx - r) / tile, tiles_x), 0, tiles_x - 1)
    tx1 = torch.clamp(_floor_index((mx + r) / tile, tiles_x), 0, tiles_x - 1)
    ty0 = torch.clamp(_floor_index((my - r) / tile, tiles_y), 0, tiles_y - 1)
    ty1 = torch.clamp(_floor_index((my + r) / tile, tiles_y), 0, tiles_y - 1)
    return tx0, tx1, ty0, ty1


def _cull_mask(mx, my, cA, cB, cC, opac, etx, ety, tile):
    """Exact-zero entry cull: True for entries whose maximum achievable
    alpha on their tile's pixel-center rectangle can clear the 1/255
    cutoff. ONE definition: the binning pass and the compaction probe
    must never diverge.

    The bound is the exact minimum of q = A dx^2 + 2B dx dy + C dy^2
    (alpha = o * exp(-q/2)) over the rectangle: zero when the mean lies
    inside, else the least of the four edges' clamped stationary points.
    Keep iff q_min <= 2*log(2*o/ALPHA_MIN), the raw opacity with a 2x
    f32-rounding margin; zero, sub-cutoff or negative opacities give -inf
    or NaN thresholds and always cull."""
    f32 = torch.float32
    thr = 2.0 * torch.log((2.0 / _ALPHA_MIN) * opac)
    rx0 = etx.to(f32) * tile + 0.5
    ry0 = ety.to(f32) * tile + 0.5
    x0 = rx0 - mx[:, None]
    x1 = x0 + (tile - 1)
    y0 = ry0 - my[:, None]
    y1 = y0 + (tile - 1)
    A = torch.clamp(cA, min=1e-12)[:, None]
    C = torch.clamp(cC, min=1e-12)[:, None]
    B = cB[:, None]

    def q(dx, dy):
        return A * dx * dx + 2.0 * B * dx * dy + C * dy * dy

    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)
    q_edges = torch.minimum(
        torch.minimum(
            q(x0, torch.clamp(-B * x0 / C, y0, y1)),
            q(x1, torch.clamp(-B * x1 / C, y0, y1)),
        ),
        torch.minimum(
            q(torch.clamp(-B * y0 / A, x0, x1), y0),
            q(torch.clamp(-B * y1 / A, x0, x1), y1),
        ),
    )
    q_min = torch.where(inside, torch.zeros_like(q_edges), q_edges)
    return q_min <= thr[:, None]


def _env_on(name: str) -> bool:
    return os.environ.get(name, "1") not in ("", "0")


def _any_transmittance(trans: torch.Tensor) -> bool:
    """Whether a pixel of these tiles has transmittance left: one host read
    of a device value."""
    COUNTS["syncs"] += 1
    return bool((trans > 0.0).any())


def _blend_chunk(i, acc, trans, st_w, sg_w, pxf_w, pyf_w, table, e_gauss_s, chunk,
                 n_slots):
    """Blend entries ``[i*chunk, i*chunk + n_slots)`` of each tile of the
    prefix into its (acc, trans), in place (``n_slots <= chunk`` covers
    every entry the prefix has left in this chunk). Every reduction runs
    along the innermost axis (cumprod, cumsum), whose association per row
    does not depend on the number of rows: a tile gets the same bits
    whichever tiles run beside it. The in-place steps round as the JAX
    package's expressions do, operation for operation."""
    W = st_w.shape[0]
    E = e_gauss_s.shape[0]
    s = i * chunk + torch.arange(n_slots, device=st_w.device)
    idx = torch.clamp(st_w[:, None] + s[None, :], max=E - 1)
    rws = table[e_gauss_s[idx].reshape(-1)].reshape(W, n_slots, table.shape[1])  # (W, C, 10)
    dx = pxf_w[:, :, None] - rws[:, None, :, 0]                                   # (W, P, C)
    dy = pyf_w[:, :, None] - rws[:, None, :, 1]
    # power = -0.5 * (A dx dx + C dy dy) - B dx dy
    power = rws[:, None, :, 2] * dx
    power.mul_(dx)
    tmp = rws[:, None, :, 4] * dy
    power.add_(tmp.mul_(dy)).mul_(-0.5)
    torch.mul(rws[:, None, :, 3], dx, out=tmp)
    power.sub_(tmp.mul_(dy))
    del dx, dy, tmp
    keep = (s[None, :] < sg_w[:, None])[:, None, :] & (power <= 0)
    # alpha = min(o * exp(min(power, 0)), ALPHA_MAX), zero below ALPHA_MIN
    alpha = torch.clamp(power, max=0.0).exp_()
    del power
    alpha = torch.mul(rws[:, None, :, 8], alpha, out=alpha).clamp_(max=_ALPHA_MAX)
    keep &= alpha >= _ALPHA_MIN
    alpha.masked_fill_(~keep, 0.0)
    del keep
    t_incl = torch.cumprod(1.0 - alpha, dim=2)
    # w = alpha * T_exclusive * trans
    alpha[:, :, 1:].mul_(t_incl[:, :, :-1])
    w = alpha.mul_(trans[:, :, None])
    for k in range(3):
        acc[:, :, k].add_(torch.cumsum(w * rws[:, None, :, 5 + k], dim=2)[:, :, -1])
    trans.mul_(t_incl[:, :, -1])


def _rasterize_tiled(means, quats, scales, opacities, sh_colors, viewmat, Kmat, background,
                     *, width: int, height: int, sh_degree: int, tile: int,
                     max_tiles_per_gauss: int, max_per_tile: int, chunk: int,
                     compact_tiles: Optional[int] = None, early_exit: bool = True):
    """One view of the tiled rasterizer on the inputs' device; returns
    (image tensor (H, W, 3), :class:`RasterMeta`). ``early_exit=False``
    runs every chunk of the blend (the same bits, slower: the check that
    the exit is exact)."""
    COUNTS["views"] += 1
    N = means.shape[0]
    dev = means.device
    f32 = torch.float32
    opac = opacities.to(f32).reshape(-1)
    means2d, conic, depths, radii, alive, vd, lam1 = project_gaussians(
        means.to(f32), quats.to(f32), scales.to(f32), opac, viewmat.to(f32), Kmat.to(f32),
        width, height)
    rgb = eval_sh(sh_colors.to(f32), vd, sh_degree)

    # depth order: one stable sort (ties keep the index order)
    inf = torch.full_like(depths, float("inf"))
    order = torch.sort(torch.where(alive, depths, inf), stable=True).indices
    # per-Gaussian render table in depth order, one wide row gather
    table = torch.cat([means2d, conic, rgb, opac[:, None], alive.to(f32)[:, None]],
                      dim=1)[order]
    g_alive = table[:, 9] > 0

    # tile footprint bounding boxes (depth order)
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    n_tiles = tiles_x * tiles_y
    mx, my, r = table[:, 0], table[:, 1], radii[order]
    tx0, tx1, ty0, ty1 = _tile_bbox(mx, my, r, tile, tiles_x, tiles_y)
    tw = tx1 - tx0 + 1
    th = ty1 - ty0 + 1
    n_cover = torch.where(g_alive, tw * th, torch.zeros_like(tw))
    dup_clipped = torch.clamp(n_cover - max_tiles_per_gauss, min=0).sum()

    # static (N, M) duplication grid: entry j of Gaussian i covers tile
    # (ty0 + j // tw, tx0 + j % tw); invalid entries get the sentinel tile
    j = torch.arange(max_tiles_per_gauss, dtype=torch.int32, device=dev)[None, :]
    tw_s = torch.clamp(tw, min=1)[:, None]
    ety = ty0[:, None] + j // tw_s
    etx = tx0[:, None] + j % tw_s
    e_valid = (j < n_cover[:, None]) & g_alive[:, None]

    # exact-zero per-entry tile cull (only f32 grouping of the blend changes)
    if _env_on("RAHT3DGS_RASTER_CULL"):
        e_valid &= _cull_mask(mx, my, table[:, 2], table[:, 3], table[:, 4], table[:, 8],
                              etx, ety, tile)

    # compaction to the post-cull width: valid entries keep their slot
    # order, so the (tile, depth-rank) keys, and the image, are unchanged
    if compact_tiles is not None and compact_tiles < max_tiles_per_gauss:
        jkey = torch.where(e_valid, j.expand_as(e_valid), max_tiles_per_gauss)
        js = torch.sort(jkey, dim=1).values[:, :compact_tiles]
        n_valid = e_valid.sum(dim=1)
        dup_clipped = dup_clipped + torch.clamp(n_valid - compact_tiles, min=0).sum()
        e_valid = js < max_tiles_per_gauss
        ety = ty0[:, None] + js // tw_s
        etx = tx0[:, None] + js % tw_s

    e_tile = torch.where(e_valid, ety * tiles_x + etx, n_tiles).to(torch.int64)

    # binning: one sort of unique int64 keys (tile << rank_bits) | depth rank
    # (the grid's row index is the depth rank), then per-tile windows
    rank_bits = max(1, int(N - 1).bit_length())
    ranks = torch.arange(N, dtype=torch.int64, device=dev)[:, None]
    packed_s = torch.sort(((e_tile << rank_bits) | ranks).reshape(-1)).values
    del e_tile, e_valid, ety, etx
    e_gauss_s = packed_s & ((1 << rank_bits) - 1)
    tid = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    bounds = tid << rank_bits
    starts = torch.searchsorted(packed_s, bounds, side="left")
    ends = torch.searchsorted(packed_s, bounds + (1 << rank_bits), side="left")
    del packed_s
    seg_len = ends - starts
    tile_clipped = torch.clamp(seg_len - max_per_tile, min=0).sum()
    seg_capped = torch.clamp(seg_len, max=max_per_tile)

    # per-tile pixel grid (pixel centers, gsplat convention)
    tpx = (tid % tiles_x) * tile
    tpy = (tid // tiles_x) * tile
    p = torch.arange(tile * tile, dtype=torch.int64, device=dev)
    pxf = (tpx[:, None] + (p % tile)[None, :]).to(f32) + 0.5
    pyf = (tpy[:, None] + (p // tile)[None, :]).to(f32) + 0.5

    # front-to-back blend: tiles by occupancy, descending, in bands of
    # shrinking width; each band runs until every tile outside the next
    # band is exhausted or saturated (the chunk counter carries across).
    # The occupancies come to the host once: the tiles with entries left at
    # chunk i are a prefix of the order, and only that prefix is blended (a
    # tile past its entries would add exactly 0.0 and keep its
    # transmittance), so only the saturation test reads the device.
    P = tile * tile
    n_chunks = (max_per_tile + chunk - 1) // chunk
    occ_perm = torch.sort(-seg_capped, stable=True).indices
    starts_o, seg_o = starts[occ_perm], seg_capped[occ_perm]
    pxf_o, pyf_o = pxf[occ_perm], pyf[occ_perm]
    COUNTS["syncs"] += 1
    neg_seg = (-seg_o).tolist()   # ascending

    widths = [n_tiles]
    while widths[-1] > 8:
        widths.append(-(-widths[-1] // 4))

    i = 0
    acc = torch.zeros((n_tiles, P, 3), dtype=f32, device=dev)
    trans = torch.ones((n_tiles, P), dtype=f32, device=dev)
    for si, Ws in enumerate(widths):
        Wn = widths[si + 1] if si + 1 < len(widths) else 0
        while i < n_chunks:
            k = min(Ws, bisect.bisect_left(neg_seg, -i * chunk))  # entries left
            if early_exit and (k <= Wn or not _any_transmittance(trans[Wn:k])):
                break
            if k:
                n_slots = min(chunk, -neg_seg[0] - i * chunk)
                _blend_chunk(i, acc[:k], trans[:k], starts_o[:k], seg_o[:k], pxf_o[:k],
                             pyf_o[:k], table, e_gauss_s, chunk, n_slots)
                COUNTS["chunks"] += 1
            i += 1

    inv_perm = torch.argsort(occ_perm)
    acc, trans = acc[inv_perm], trans[inv_perm]
    img_tiles = acc + trans[:, :, None] * background[None, None, :]
    img = (img_tiles.reshape(tiles_y, tiles_x, tile, tile, 3)
           .permute(0, 2, 1, 3, 4)
           .reshape(tiles_y * tile, tiles_x * tile, 3))[:height, :width]
    return img, RasterMeta(dup_clipped, tile_clipped)


def _rasterize_dense(means, quats, scales, opacities, sh_colors, viewmat, Kmat, background,
                     *, width: int, height: int, sh_degree: int, tile: int):
    """Dense reference: every Gaussian against every pixel, O(H*W*N).

    Memory- and compute-unbounded in N: for tests and small crops only."""
    f32 = torch.float32
    opac = opacities.to(f32).reshape(-1)
    means2d, conic, depths, radii, alive, vd, _ = project_gaussians(
        means.to(f32), quats.to(f32), scales.to(f32), opac, viewmat.to(f32), Kmat.to(f32),
        width, height)
    rgb = eval_sh(sh_colors.to(f32), vd, sh_degree)

    inf = torch.full_like(depths, float("inf"))
    order = torch.sort(torch.where(alive, depths, inf), stable=True).indices
    mx, my = means2d[order, 0], means2d[order, 1]
    A, B, Cc = conic[order, 0], conic[order, 1], conic[order, 2]
    col = rgb[order]
    op = opac[order]
    ok = alive[order]
    r = radii[order]

    # the tiled program's tile-membership cutoff, replicated exactly (the
    # same square cutoff for the same tile size, not a radius test)
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    tx0, tx1, ty0, ty1 = _tile_bbox(mx, my, r, tile, tiles_x, tiles_y)

    dev = means.device
    py, px = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev),
                            indexing="ij")
    px = px.reshape(-1)
    py = py.reshape(-1)
    pxf = px.to(f32) + 0.5                               # (P,)
    pyf = py.to(f32) + 0.5
    dx = pxf[:, None] - mx[None, :]                      # (P, N)
    dy = pyf[:, None] - my[None, :]
    ptx = (px // tile)[:, None]
    pty = (py // tile)[:, None]
    inside = ((ptx >= tx0[None, :]) & (ptx <= tx1[None, :])
              & (pty >= ty0[None, :]) & (pty <= ty1[None, :]))
    power = -0.5 * (A[None, :] * dx * dx + Cc[None, :] * dy * dy) - B[None, :] * dx * dy
    alpha = torch.clamp(op[None, :] * torch.exp(torch.clamp(power, max=0.0)), max=_ALPHA_MAX)
    alpha = torch.where(ok[None, :] & inside & (power <= 0) & (alpha >= _ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(one_m[:, :1]), torch.cumprod(one_m, dim=1)[:, :-1]],
                       dim=1)
    w = alpha * t_excl
    img = w @ col + (t_excl[:, -1] * one_m[:, -1])[:, None] * background[None, :]
    return img.reshape(height, width, 3)


def _probe_bbox(means, quats, scales, opacities, viewmat, Kmat, width, height, tile):
    """Shared probe preamble: projection + tile bboxes (THE bbox formula,
    :func:`_tile_bbox`), as the binning pass sees them."""
    f32 = torch.float32
    means2d, conic, depths, radii, alive, vd, _ = project_gaussians(
        means.to(f32), quats.to(f32), scales.to(f32), opacities.to(f32).reshape(-1),
        viewmat.to(f32), Kmat.to(f32), width, height)
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    mx, my, r = means2d[:, 0], means2d[:, 1], radii
    tx0, tx1, ty0, ty1 = _tile_bbox(mx, my, r, tile, tiles_x, tiles_y)
    tw = tx1 - tx0 + 1
    n_cover = torch.where(alive, tw * (ty1 - ty0 + 1), torch.zeros_like(tw))
    return mx, my, conic, tx0, ty0, tw, n_cover


def _max_tile_cover(means, quats, scales, opacities, viewmat, Kmat, *, width, height, tile):
    """Max tiles any alive Gaussian covers in this view (the binning
    pass's bbox formula), a device scalar."""
    n_cover = _probe_bbox(means, quats, scales, opacities, viewmat, Kmat, width, height,
                          tile)[-1]
    return n_cover.max()


def _max_valid_cover(means, quats, scales, opacities, viewmat, Kmat, *, width, height, tile,
                     m):
    """Max per-Gaussian count of entries surviving the exact-zero cull
    (:func:`_cull_mask`, as the binning pass) at the bbox budget ``m``:
    the compaction width probe, a device scalar."""
    mx, my, conic, tx0, ty0, tw, n_cover = _probe_bbox(
        means, quats, scales, opacities, viewmat, Kmat, width, height, tile)
    j = torch.arange(m, dtype=torch.int32, device=means.device)[None, :]
    tw_s = torch.clamp(tw, min=1)[:, None]
    ety = ty0[:, None] + j // tw_s
    etx = tx0[:, None] + j % tw_s
    e_valid = j < n_cover[:, None]
    e_valid &= _cull_mask(mx, my, conic[:, 0], conic[:, 1], conic[:, 2],
                          opacities.to(torch.float32).reshape(-1), etx, ety, tile)
    return e_valid.sum(dim=1).max()


def _tensors(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _read_int(x: torch.Tensor) -> int:
    COUNTS["syncs"] += 1
    return int(x)


def auto_tile_budget(means, quats, scales, opacities, viewmat, Kmat, *, width: int,
                     height: int, tile: int = 16, cap: int = 256,
                     device: DeviceLike = None) -> int:
    """Adaptive ``max_tiles_per_gauss``: the view's actual per-Gaussian max
    tile coverage, rounded up to a power of two (floor 4, capped), so the
    budget is >= the true max and ``dup_clipped == 0``."""
    dev = device_of(means, device)
    need = _read_int(_max_tile_cover(*_tensors(dev, means, quats, scales, opacities, viewmat,
                                               Kmat), width=width, height=height, tile=tile))
    budget = 4
    while budget < need and budget < cap:
        budget *= 2
    return budget


def _prepare(colors, background, sh_degree, dev):
    """SH colours (N, K, 3), their degree, and the background (white by
    default) on ``dev``."""
    sh, inferred = _colors_to_sh(torch.as_tensor(colors, device=dev))
    bg = torch.as_tensor(1.0 if background is None else background, dtype=torch.float32,
                         device=dev).expand(3)
    return sh, inferred if sh_degree is None else sh_degree, bg


def rasterize_gaussians(means, quats, scales, opacities, colors, viewmat, Kmat, width: int,
                        height: int, sh_degree: Optional[int] = None,
                        background: Optional[np.ndarray] = None, tile: int = 16,
                        max_tiles_per_gauss=32, max_per_tile: int = 1024, chunk: int = 128,
                        device: DeviceLike = None) -> Tuple[np.ndarray, RasterMeta]:
    """Render one view of a 3DGS scene on CUDA (unless ``device="cpu"``, or
    the inputs are tensors on another device).

    Args:
        means/quats/scales/opacities: (N,3)/(N,4 wxyz)/(N,3 linear)/(N,)
            Gaussian parameters, activations applied.
        colors: (N, 3K) flat or (N, K, 3) SH coefficients (K = 1 is the
            DC-only case).
        viewmat: (4, 4) world-to-camera; Kmat: (3, 3) pinhole intrinsics.
        sh_degree: inferred from K when None.
        background: (3,) colour, white by default (reference parity).
        tile / max_tiles_per_gauss / max_per_tile / chunk: capacity knobs;
            overflows are counted in :class:`RasterMeta`.
            ``max_tiles_per_gauss="auto"`` measures the view's max coverage
            first (:func:`auto_tile_budget`) and, with the cull and
            compaction on, the post-cull width (:func:`_max_valid_cover`).

    Returns:
        (image (H, W, 3) float32 numpy array, RasterMeta of device scalars).
    """
    dev = device_of(means, device)
    t_means, t_quats, t_scales, t_opac, t_view, t_K = _tensors(
        dev, means, quats, scales, opacities, viewmat, Kmat)
    compact_tiles = None
    if max_tiles_per_gauss == "auto":
        max_tiles_per_gauss = auto_tile_budget(t_means, t_quats, t_scales, t_opac, t_view,
                                               t_K, width=width, height=height, tile=tile)
        if _env_on("RAHT3DGS_RASTER_CULL") and _env_on("RAHT3DGS_RASTER_COMPACT"):
            need = _read_int(_max_valid_cover(t_means, t_quats, t_scales, t_opac, t_view, t_K,
                                              width=width, height=height, tile=tile,
                                              m=max_tiles_per_gauss))
            c = 4
            while c < need:
                c *= 2
            if c < max_tiles_per_gauss:
                compact_tiles = c
    sh, sh_degree, bg = _prepare(colors, background, sh_degree, dev)
    img, meta = _rasterize_tiled(
        t_means, t_quats, t_scales, t_opac, sh, t_view, t_K, bg, width=width, height=height,
        sh_degree=sh_degree, tile=tile, max_tiles_per_gauss=max_tiles_per_gauss,
        max_per_tile=max_per_tile, chunk=chunk, compact_tiles=compact_tiles)
    COUNTS["syncs"] += 1
    return img.cpu().numpy(), meta


def rasterize_dense(means, quats, scales, opacities, colors, viewmat, Kmat, width: int,
                    height: int, sh_degree: Optional[int] = None,
                    background: Optional[np.ndarray] = None, tile: int = 16,
                    device: DeviceLike = None) -> np.ndarray:
    """Dense (un-tiled) golden renderer, O(H*W*N): small scenes only.

    ``tile`` must match the tiled call under comparison: the per-Gaussian
    evaluation cutoff is tile-bbox membership, which depends on it."""
    dev = device_of(means, device)
    t = _tensors(dev, means, quats, scales, opacities, viewmat, Kmat)
    sh, sh_degree, bg = _prepare(colors, background, sh_degree, dev)
    img = _rasterize_dense(*t[:4], sh, *t[4:], bg, width=width, height=height,
                           sh_degree=sh_degree, tile=tile)
    return img.cpu().numpy()
