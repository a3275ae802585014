"""Seeded inputs of the benchmark's cells, made on the device in a few
large calls from one ``torch.Generator``.

Frozen copies of the program's generators, redrawn in torch so that a
frame or a scene is made on the card in milliseconds instead of seconds
of numpy on the host (the same seed always gives the same inputs on one
kind of device; the program's own ``numpy`` draws differ, the sizes and
shapes do not):

- :func:`dataset_frame` is ``raht3dgs_tpu_torch/utils/synth.py:168``: an
  8iVFBv2-sized frame, points on three jittered sphere shells floored to
  the ``2**depth`` grid, shifted a voxel along x a frame, deduplicated (a
  voxel keeps its first point's colour), with integer RGB that varies
  smoothly over the surface. 1 500 000 points give about 810 000 voxels
  at J=10, as ``loot_vox10`` frames hold.
- :func:`gaussian_scene` is ``utils/synth.py:107`` on ``raw_surface_cloud``
  (``:85``): Gaussians on three smaller shells in the unit cube, unit
  quaternions, scales ``exp(N(-6, 0.3))``, opacities in (0.05, 1) and 48
  SH colours (the DC term from the smooth RGB, 45 small higher-order
  terms), in float32 as a trained checkpoint stores them. 2 000 000 merge
  to about 487 000 voxels at J=10.
"""

from __future__ import annotations

import math

import torch

SURFACE_JITTER = 0.002
DATASET_CENTERS = ((0.2, 0.2, 0.5), (0.75, 0.3, 0.5), (0.5, 0.75, 0.5))
DATASET_RADII = (0.168, 0.124, 0.09)
SURFACE_CENTERS = ((0.12, 0.12, 0.12), (0.88, 0.88, 0.88), (0.85, 0.2, 0.5))
SURFACE_RADII = (0.11, 0.08, 0.06)
SH_C0 = 0.28209479177387814
_PHASE = (0.0, 2.1, 4.2)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any size: it is
    folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _shells(g: torch.Generator, n: int, centers, radii, device):
    """``n`` points on jittered sphere shells, each shell drawn in
    proportion to its area: ``(points (n, 3) f64, directions (n, 3))``."""
    c = torch.tensor(centers, dtype=torch.float64, device=device)
    r0 = torch.tensor(radii, dtype=torch.float64, device=device)
    k = torch.multinomial(r0 ** 2 / (r0 ** 2).sum(), n, replacement=True, generator=g)
    d = torch.randn(n, 3, generator=g, device=device, dtype=torch.float64)
    d /= torch.linalg.norm(d, dim=1, keepdim=True)
    r = r0[k] * (1.0 + SURFACE_JITTER * torch.randn(n, generator=g, device=device,
                                                    dtype=torch.float64))
    return c[k] + r[:, None] * d, d


def _smooth_rgb(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    phase = torch.tensor(_PHASE, dtype=torch.float64, device=x.device)
    rgb = torch.round(127.5 * (1.0 + torch.sin(6.0 * math.pi * x[:, None] + 4.0 * d + phase)))
    return rgb.clamp(0, 255)


def morton(V: torch.Tensor, depth: int) -> torch.Tensor:
    """int64 Morton codes, x most significant in each triple (the layout of
    ``reference/raht.py:morton_codes``)."""
    M = torch.zeros(V.shape[0], dtype=torch.int64, device=V.device)
    for i in range(depth):
        b = (V >> i) & 1
        M |= (b[:, 2] + (b[:, 1] << 1) + (b[:, 0] << 2)) << (3 * i)
    return M


def dataset_frame(g: torch.Generator, frame: int, n_points: int, depth: int, device):
    """Frame ``frame`` of a dataset sequence: ``(V (n, 3) int64, rgb (n, 3)
    int64)`` as host numpy, Morton-sorted unique voxels."""
    pts, d = _shells(g, n_points, DATASET_CENTERS, DATASET_RADII, device)
    side = 1 << depth
    V = torch.floor(pts * side).to(torch.int64)
    V[:, 0] += frame
    V = V.clamp(0, side - 1)
    codes, idx = torch.sort(morton(V, depth), stable=True)
    first = idx[torch.cat([codes.new_ones(1, dtype=torch.bool), codes[1:] != codes[:-1]])]
    rgb = _smooth_rgb(pts[first, 0], d[first]).to(torch.int64)
    return V[first].cpu().numpy(), rgb.cpu().numpy()


def gaussian_scene(g: torch.Generator, n: int, device) -> dict:
    """``n`` Gaussians as float32 host numpy: means (n, 3), quats (n, 4),
    scales (n, 3), opacities (n,), colors (n, 48)."""
    pts, d = _shells(g, n, SURFACE_CENTERS, SURFACE_RADII, device)
    pts = pts.to(torch.float32)
    rgb = _smooth_rgb(pts[:, 0].double(), d)
    quats = torch.randn(n, 4, generator=g, device=device, dtype=torch.float64)
    quats /= torch.linalg.norm(quats, dim=1, keepdim=True)
    scales = torch.exp(-6.0 + 0.3 * torch.randn(n, 3, generator=g, device=device,
                                                 dtype=torch.float64))
    opac = 0.05 + 0.95 * torch.rand(n, generator=g, device=device, dtype=torch.float64)
    dc = (rgb / 255.0 - 0.5) / SH_C0
    rest = 0.02 * torch.randn(n, 45, generator=g, device=device, dtype=torch.float64)
    colors = torch.cat([dc, rest], dim=1)
    out = {"means": pts, "quats": quats, "scales": scales, "opacities": opac,
           "colors": colors}
    return {k: v.to(torch.float32).cpu().numpy() for k, v in out.items()}

