"""Plain 3D Gaussian Splatting rasterizer of the benchmark's reference.

One view of the image formation of Kerbl et al., *3D Gaussian Splatting
for Real-Time Radiance Field Rendering* (SIGGRAPH 2023), with gsplat's
conventions as ``raht3dgs_tpu_torch/eval/rasterize.py``'s docstring states
them, in plain torch on the host, float64 unless told otherwise (the
lower-precision control passes ``dtype``):

- **Projection (EWA).** ``Sigma = R S S^T R^T`` from the normalized
  quaternion (wxyz; a zero quaternion is the identity) and the per-axis
  scales; the camera-space mean ``t = W p + c``; the perspective Jacobian
  with the tangent offsets ``x/z``, ``y/z`` clamped to 1.3 times the half
  field of view; ``Sigma' = J W Sigma W^T J^T + 0.3 I``; the conic is
  ``Sigma'^-1``. A Gaussian is drawn when its depth is above the near
  plane 0.01, ``det Sigma' > 0``, its 3-sigma radius ``ceil(3
  sqrt(lambda_max))`` is positive, its square of that radius meets the
  image and its opacity is positive.
- **Colour.** Real spherical harmonics to degree 3 along the unit
  direction from the camera centre to the mean, ``rgb = max(SH + 0.5, 0)``.
- **Alpha.** ``alpha = min(o exp(power), 0.999)`` with ``power = -1/2 d^T
  Sigma'^-1 d`` at the pixel centre (``x + 0.5``, ``y + 0.5``), zero where
  ``power > 0`` or ``alpha < 1/255``.
- **Blend.** Front to back in depth order (a stable sort: equal depths
  keep the row order), ``C = sum_i alpha_i T_i c_i + T_final bg`` with
  ``T_i = prod_{j<i} (1 - alpha_j)``, over every entry a pixel's tile
  holds: no early-stop threshold.

**Capacity rules**, the port's, applied here so that the image is the
program's own and their counts can be compared:

- a Gaussian's entries are the 16x16-pixel tiles of the square box of its
  radius (tile indices ``floor((m -+ r) / 16)`` clamped to the grid), in
  row-major order over the box; it keeps the first ``max_tiles_per_gauss``
  of them (``dup_clipped`` counts the rest);
- an entry is binned only when the Gaussian's largest alpha over its
  tile's rectangle of pixel centres (the whole 16x16 tile, also where the
  last row or column of tiles passes the image's edge) can reach the
  1/255 cutoff with twice the opacity: ``min q <= 2 log(2 o 255)`` for
  ``q = d^T Sigma'^-1 d``, the exact minimum over the rectangle. Such an
  entry adds exactly 0 to every pixel, so this changes the image only
  through the next rule;
- a tile keeps its ``max_per_tile`` nearest entries (``tile_clipped``
  counts the rest); ``entries`` counts those it keeps.

**Departures from gsplat**: no antialiasing compensation (gsplat's
``antialiased=False``); the tile box is the square of the radius, not
the ellipse's own box; the two capacity rules above do not exist in
gsplat (at the benchmark's sizes both clip: the image is the capped
image, whose counts :class:`View` reports); the blend does not stop at a
transmittance threshold (gsplat stops below 1e-4, the port only where
every pixel's transmittance is exactly 0); the background is added as
``T_final bg``. The 56-channel scene layout of the codec's serving path
(:func:`scene_from_payload`) is the port's (``models/serving.py``).

:class:`View` projects and bins a whole view (its clip counts are the
view's) and renders any subset of tiles exactly, each tile's pixels from
its own entries, so that a check can afford a sample of a large image.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
NEAR_PLANE = 0.01
EPS2D = 0.3
TILE = 16

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _t(x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)


def scene_from_payload(V, attrs, voxel_size: float, vmin, dtype=torch.float64):
    """The scene the serving path renders from a decoded 56-channel payload
    ``[quats 4, scales 3, opacity 1, SH colours 48]`` at integer voxels
    ``V (n, 3)``: means at the voxel centres ``(V + 0.5) voxel_size +
    vmin``, scales at least 1e-5, opacity clipped to [0, 1], colours as 16
    coefficients of RGB. Returns ``(means, quats, scales, opacities,
    colors (n, 16, 3))`` in ``dtype``."""
    a = torch.as_tensor(np.asarray(attrs, np.float64)).to(dtype)
    means = (_t(V, dtype) + 0.5) * _t(voxel_size, dtype) + _t(vmin, dtype)[None, :]
    return (means, a[:, 0:4], torch.clamp(a[:, 4:7], min=1e-5),
            torch.clamp(a[:, 7], 0.0, 1.0), a[:, 8:].reshape(a.shape[0], -1, 3))


def sh_rgb(colors: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """``max(SH(dirs) + 0.5, 0)`` of coefficients ``(n, K, 3)`` to ``degree``."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    c = colors
    out = SH_C0 * c[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * c[:, 1] + SH_C1 * z * c[:, 2] - SH_C1 * x * c[:, 3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis2 = (x * y, y * z, 2 * zz - xx - yy, x * z, xx - yy)
        for k, (cst, b) in enumerate(zip(SH_C2, basis2)):
            out = out + cst * b * c[:, 4 + k]
    if degree >= 3:
        basis3 = (y * (3 * xx - yy), x * y * z, y * (4 * zz - xx - yy),
                  z * (2 * zz - 3 * xx - 3 * yy), x * (4 * zz - xx - yy), z * (xx - yy),
                  x * (xx - 3 * yy))
        for k, (cst, b) in enumerate(zip(SH_C3, basis3)):
            out = out + cst * b * c[:, 9 + k]
    return torch.clamp(out + 0.5, min=0.0)


def _rotations(quats: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(quats, dim=1, keepdim=True)
    ident = torch.zeros_like(quats)
    ident[:, 0] = 1.0
    q = torch.where(n > 1e-12, quats / torch.where(n > 1e-12, n, torch.ones_like(n)), ident)
    w, x, y, z = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1),
    ], 1)


class Projected(NamedTuple):
    mx: torch.Tensor
    my: torch.Tensor
    conic: torch.Tensor      # (n, 3): A, B, C of [A B; B C] = Sigma'^-1
    depth: torch.Tensor
    radius: torch.Tensor
    alive: torch.Tensor
    dirs: torch.Tensor


def project(means, quats, scales, opacities, viewmat, K, width: int, height: int,
            dtype=torch.float64) -> Projected:
    """EWA projection of every Gaussian of one view, in ``dtype``."""
    m, q, s, o = (torch.as_tensor(a).to(dtype) for a in (means, quats, scales, opacities))
    Wm, Km = _t(viewmat, dtype), _t(K, dtype)
    R, t = Wm[:3, :3], Wm[:3, 3]
    cam = m @ R.T + t
    depth = cam[:, 2]
    alive = depth > NEAR_PLANE
    z = torch.where(alive, depth, torch.ones_like(depth))
    fx, fy, cx, cy = Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]
    mx = fx * cam[:, 0] / z + cx
    my = fy * cam[:, 1] / z + cy
    RS = _rotations(q) * s[:, None, :]
    Mc = R @ (RS @ RS.transpose(1, 2)) @ R.T
    tx = z * torch.clamp(cam[:, 0] / z, -1.3 * (width / 2.0) / fx, 1.3 * (width / 2.0) / fx)
    ty = z * torch.clamp(cam[:, 1] / z, -1.3 * (height / 2.0) / fy, 1.3 * (height / 2.0) / fy)
    J = torch.zeros(m.shape[0], 2, 3, dtype=dtype)
    J[:, 0, 0] = fx / z
    J[:, 0, 2] = -fx * tx / (z * z)
    J[:, 1, 1] = fy / z
    J[:, 1, 2] = -fy * ty / (z * z)
    cov = J @ Mc @ J.transpose(1, 2)
    a, b, c = cov[:, 0, 0] + EPS2D, cov[:, 0, 1], cov[:, 1, 1] + EPS2D
    det = a * c - b * b
    alive &= det > 0
    det = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det, -b / det, a / det], 1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    alive &= (radius > 0) & (mx + radius > 0) & (mx - radius < width)
    alive &= (my + radius > 0) & (my - radius < height) & (o > 0)
    centre = -R.T @ t
    d = m - centre
    dirs = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-12)
    return Projected(mx, my, conic, depth, radius, alive, dirs)


def _rect_min_q(A, B, C, x0, x1, y0, y1):
    """The least ``A dx^2 + 2 B dx dy + C dy^2`` over ``[x0, x1] x [y0, y1]``
    (offsets of the rectangle from the mean) for a positive-definite form:
    0 when the rectangle holds the mean, else the least over its edges,
    each at the form's stationary point along the edge, clamped to it."""
    def q(dx, dy):
        return A * dx * dx + 2.0 * B * dx * dy + C * dy * dy

    edges = torch.stack([
        q(x0, torch.clamp(-B * x0 / C, y0, y1)), q(x1, torch.clamp(-B * x1 / C, y0, y1)),
        q(torch.clamp(-B * y0 / A, x0, x1), y0), q(torch.clamp(-B * y1 / A, x0, x1), y1),
    ]).min(dim=0).values
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    return torch.where(inside, torch.zeros_like(edges), edges)


class View:
    """One view projected and binned: ``dup_clipped``, ``tile_clipped`` and
    ``entries`` are the whole view's; :meth:`render_tiles` renders any
    tiles of it."""

    def __init__(self, scene, viewmat, K, width: int, height: int, *, sh_degree: int = 3,
                 max_tiles_per_gauss: int = 16, max_per_tile: int = 8192, background=None,
                 dtype=torch.float64):
        means, quats, scales, opac, colors = scene
        self.dtype = dtype
        self.width, self.height = width, height
        self.tiles_x = -(-width // TILE)
        self.tiles_y = -(-height // TILE)
        self.n_tiles = self.tiles_x * self.tiles_y
        self.max_per_tile = max_per_tile
        self.bg = _t(np.ones(3) if background is None else background, dtype)
        p = project(means, quats, scales, opac, viewmat, K, width, height, dtype)
        o = torch.as_tensor(opac).to(dtype)
        inf = torch.full_like(p.depth, math.inf)
        order = torch.sort(torch.where(p.alive, p.depth, inf), stable=True).indices
        alive = p.alive[order]
        order = order[alive]                 # drawn Gaussians, nearest first
        self.mx, self.my = p.mx[order], p.my[order]
        self.conic = p.conic[order]
        self.opac = o[order]
        self.rgb = sh_rgb(torch.as_tensor(colors).to(dtype)[order], p.dirs[order], sh_degree)
        r = p.radius[order]

        def tile_of(v, n):
            return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int64)

        tx0, tx1 = tile_of(self.mx - r, self.tiles_x), tile_of(self.mx + r, self.tiles_x)
        ty0, ty1 = tile_of(self.my - r, self.tiles_y), tile_of(self.my + r, self.tiles_y)
        tw = tx1 - tx0 + 1
        cover = tw * (ty1 - ty0 + 1)
        M = max_tiles_per_gauss
        self.dup_clipped = int(torch.clamp(cover - M, min=0).sum())
        j = torch.arange(M)[None, :]
        ety = ty0[:, None] + j // tw[:, None]
        etx = tx0[:, None] + j % tw[:, None]
        x0 = (etx * TILE).to(dtype) + 0.5 - self.mx[:, None]
        y0 = (ety * TILE).to(dtype) + 0.5 - self.my[:, None]
        A, B, C = (self.conic[:, k, None] for k in range(3))
        qmin = _rect_min_q(A, B, C, x0, x0 + (TILE - 1), y0, y0 + (TILE - 1))
        thr = 2.0 * torch.log(2.0 * self.opac[:, None] / ALPHA_MIN)
        keep = (j < cover[:, None]) & (qmin <= thr)
        rank = torch.arange(len(order))[:, None].expand_as(keep)
        self._tile = (ety * self.tiles_x + etx)[keep]     # entries, rank-major order
        self._rank = rank[keep]
        counts = torch.bincount(self._tile, minlength=self.n_tiles)
        self.tile_clipped = int(torch.clamp(counts - max_per_tile, min=0).sum())
        self.entries = int(torch.clamp(counts, max=max_per_tile).sum())
        self.counts = counts

    def render_tiles(self, tiles: Sequence[int]) -> torch.Tensor:
        """``(len(tiles), 16, 16, 3)`` colours of the tiles ``tiles`` (tile
        ``t`` is row ``t // tiles_x``, column ``t % tiles_x``), rows and
        columns past the image's edge included."""
        tiles = [int(t) for t in tiles]
        want = torch.zeros(self.n_tiles, dtype=torch.bool)
        want[tiles] = True
        sel = want[self._tile]
        tile_s, rank_s = self._tile[sel], self._rank[sel]   # rank order within each tile
        pix = torch.arange(TILE * TILE)
        out = torch.empty(len(tiles), TILE, TILE, 3, dtype=self.dtype)
        for k, t in enumerate(tiles):
            g = rank_s[tile_s == t][:self.max_per_tile]
            px = ((t % self.tiles_x) * TILE + pix % TILE).to(self.dtype) + 0.5
            py = ((t // self.tiles_x) * TILE + pix // TILE).to(self.dtype) + 0.5
            dx = px[:, None] - self.mx[g][None, :]
            dy = py[:, None] - self.my[g][None, :]
            A, B, C = (self.conic[g, i][None, :] for i in range(3))
            power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
            alpha = torch.clamp(self.opac[g][None, :] * torch.exp(torch.clamp(power, max=0.0)),
                                max=ALPHA_MAX)
            alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha,
                                torch.zeros_like(alpha))
            ones = torch.ones(alpha.shape[0], 1, dtype=self.dtype)
            trans = torch.cumprod(torch.cat([ones, 1.0 - alpha], 1), 1)
            rgb = (alpha * trans[:, :-1]) @ self.rgb[g] + trans[:, -1:] * self.bg[None, :]
            out[k] = rgb.reshape(TILE, TILE, 3)
        return out


def display_u8(rgb: torch.Tensor) -> torch.Tensor:
    """The display convention of the serving path's 8-bit images:
    ``clip(rgb, 0, 1) * 255``, truncated."""
    return torch.floor(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def image_tiles(image: np.ndarray, tiles: Sequence[int], tiles_x: int) -> np.ndarray:
    """The 16x16 blocks of an ``(H, W, 3)`` image at ``tiles``, zero past
    the image's edge."""
    H, W = image.shape[:2]
    pad = np.zeros((-(-H // TILE) * TILE, tiles_x * TILE) + image.shape[2:], image.dtype)
    pad[:H, :W] = image
    out = np.empty((len(tiles), TILE, TILE) + image.shape[2:], image.dtype)
    for k, t in enumerate(tiles):
        y, x = (int(t) // tiles_x) * TILE, (int(t) % tiles_x) * TILE
        out[k] = pad[y:y + TILE, x:x + TILE]
    return out


def render(scene, viewmat, K, width: int, height: int, *, tiles: Optional[Sequence[int]] = None,
           **kw):
    """The whole ``(H, W, 3)`` image (or, with ``tiles``, those tiles) and
    the :class:`View`."""
    v = View(scene, viewmat, K, width, height, **kw)
    if tiles is not None:
        return v.render_tiles(tiles), v
    blocks = v.render_tiles(range(v.n_tiles))
    img = blocks.reshape(v.tiles_y, v.tiles_x, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(v.tiles_y * TILE, v.tiles_x * TILE, 3)[:height, :width], v
