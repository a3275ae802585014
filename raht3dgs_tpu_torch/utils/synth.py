"""Seeded synthetic voxel frames in numpy (no device, no JAX).

The port's own copies of the helpers the JAX package keeps in
``tests/conftest.py:unique_voxel_cloud`` and
``__graft_entry__.py:_synthetic_frame``, so that tests and
``chip_smoke.py`` build the same frames from the same seeds
(``morton_codes_np``, the JAX package's ``ops/prelude.py`` helper, lives
in ``ops/morton.py``).
"""

from __future__ import annotations

import numpy as np

from raht3dgs_tpu_torch.ops.morton import morton_codes_np


def unique_voxel_cloud(rng: np.random.Generator, n: int, depth: int,
                       d_attr: int = 3):
    """Up to ``n`` integer voxel positions with unique Morton codes, Morton-
    sorted, plus uniform [0, 255) attributes: ``(pts f64, codes, attrs)``."""
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    codes = morton_codes_np(pts, depth)
    _, first = np.unique(codes, return_index=True)
    first = first[:n]
    pts = pts[first]
    codes = codes[first]
    order = np.argsort(codes)
    attrs = rng.uniform(0, 255, size=(len(order), d_attr))
    return pts[order].astype(np.float64), codes[order], attrs


def synthetic_positions(n: int, depth: int, d_attr: int, seed: int = 0):
    """``n`` (or fewer, after dedup) unique integer voxel positions in
    ``[0, 2**depth)^3`` and uniform [0, 255) attributes — the frame of
    ``__graft_entry__._synthetic_frame`` before padding, as positions."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 2**depth, size=(2 * n, 3))
    _, first = np.unique(morton_codes_np(pts, depth), return_index=True)
    first = first[:n]
    attrs = rng.uniform(0, 255, size=(len(first), d_attr))
    return pts[first], attrs


# The golden fixture of tests/test_pipeline.py::test_stream_format_frozen:
# 600 voxels at J=6 with integer colours, bucket 1024, step 4. Its prefix
# sums are exact integers, so its float64 stream does not depend on the
# summation order, and the port's CPU and CUDA runs must give the same
# bytes. These are the port's own hashes (the JAX package's differ: XLA:CPU
# contracts some products into fused multiply-adds, which moves a few
# coefficients that sit on quantization ties).
GOLDEN_DEPTH = 6
GOLDEN_BUCKET = 1024
GOLDEN_STEP = 4.0
GOLDEN_SHA256 = {
    "float64": "c64b25eb1c839a4b028184f47c785316747ff1c15e31f3ed3fdcd1cd5239d3ce",
    "float32": "a9b2fe7b64c2f6f57a11a548949226564911a643018b97f05d351f3353b09552",
}
# The same float64 stream under the RAC and ``auto`` entropy choices, with
# the fixture's lossless geometry section attached (``auto`` keeps plain
# RAC on every channel of this fixture, so both give the same bytes).
GOLDEN_ENTROPY_SHA256 = {
    "rac": "e7386d762028e004693fd908d71ed2fd3f68973b36cda61f79944727fa0e67fb",
    "auto": "e7386d762028e004693fd908d71ed2fd3f68973b36cda61f79944727fa0e67fb",
}


def golden_fixture():
    """``(positions, integer colours)`` of the golden fixture."""
    pts, _, _ = unique_voxel_cloud(np.random.default_rng(42), 600, GOLDEN_DEPTH)
    return pts, (pts * 7 % 256).astype(np.float64)


# The raw J10 cloud: three jittered sphere shells in the unit cube, spread
# corner to corner, as a full-body scan sits in its grid. At 2 000 000
# points and seed 0 it voxelizes at J=10 to 487 180 voxels (4.1 points a
# voxel, longest run 21 points): a 2^19 bucket holds it.
SURFACE_CENTERS = ((0.12, 0.12, 0.12), (0.88, 0.88, 0.88), (0.85, 0.2, 0.5))
SURFACE_RADII = (0.11, 0.08, 0.06)
SURFACE_JITTER = 0.002


def raw_surface_cloud(n: int, seed: int = 0):
    """``n`` raw float32 points on jittered sphere shells (each shell drawn
    in proportion to its area) and integer RGB colours in [0, 255] that
    vary smoothly over the surface: ``(points (n, 3) f32, rgb (n, 3) f64)``."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(SURFACE_CENTERS)
    radii = np.asarray(SURFACE_RADII)
    area = radii ** 2
    k = rng.choice(len(radii), size=n, p=area / area.sum())
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radii[k] * (1.0 + SURFACE_JITTER * rng.standard_normal(n))
    pts = (centers[k] + r[:, None] * d).astype(np.float32)
    phase = np.array([0.0, 2.1, 4.2])
    rgb = np.round(127.5 * (1.0 + np.sin(6.0 * np.pi * pts[:, [0]] + 4.0 * d + phase)))
    return pts, np.clip(rgb, 0, 255)


# A seeded 3DGS scene on the raw J10 cloud's surface. At 2 000 000
# Gaussians and seed 0 its means are that cloud's points, so at J=10 they
# voxelize to the same 487 180 voxels.
SH_C0 = 0.28209479177387814  # degree-0 spherical harmonic


def gaussian_scene(n: int, seed: int = 0):
    """``n`` Gaussians as a gsplat checkpoint loads them (float64 numpy):
    means on :func:`raw_surface_cloud`'s shells, unit quaternions, scales
    ``exp(N(-6, 0.3))``, opacities in (0.05, 1) and 48 SH colour channels
    (the DC term from the cloud's RGB, ``(rgb / 255 - 0.5) / SH_C0``, then
    45 small higher-order terms). Returns a dict of means (n, 3), quats
    (n, 4), scales (n, 3), opacities (n,) and colors (n, 48)."""
    pts, rgb = raw_surface_cloud(n, seed)
    rng = np.random.default_rng([seed, 1])
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(rng.normal(-6.0, 0.3, size=(n, 3)))
    opacities = rng.uniform(0.05, 1.0, size=n)
    dc = (rgb / 255.0 - 0.5) / SH_C0
    colors = np.concatenate([dc, rng.normal(scale=0.02, size=(n, 45))], axis=1)
    return {"means": pts.astype(np.float64), "quats": quats, "scales": scales,
            "opacities": opacities, "colors": colors}


# The 3DGS golden fixture: the 371 occupied J=5 cells of a 1 500-Gaussian
# scene, one voxel each with the 56-channel payload [quats, scales, opacity,
# colors] of its first Gaussian, every value rounded to a multiple of 2^-10.
# Each prefix sum of the transform is then exact in float64 (and in the
# float32 scan), so the stream does not depend on the summation order and
# the card must give the CPU's bytes. Hashes of the port's
# ``AttributeCodec(GS_GOLDEN_DEPTH).encode(frame, GS_GOLDEN_STEP)`` stream.
GS_GOLDEN_DEPTH = 5
GS_GOLDEN_BUCKET = 1024
GS_GOLDEN_STEP = 0.05
GS_GOLDEN_SHA256 = {
    "float64": "60666bbeb5d0a4f44f4179ab635d0bd6eb9e91340566f08d703268e8251a40ef",
    "float32": "27e9e92b44d599aef7ee62fab66a2b6546475ea79180c71cafa0d264269db341",
}


def gs_golden_fixture():
    """``(integer voxel positions (n, 3), payload (n, 56))`` of the 3DGS
    golden fixture, Morton-sorted."""
    scene = gaussian_scene(1500, seed=5)
    m = scene["means"]
    vmin = m.min(axis=0)
    width = float((m - vmin).max())
    lim = (1 << GS_GOLDEN_DEPTH) - 1
    V = np.clip(np.floor((m - vmin) / (width / (1 << GS_GOLDEN_DEPTH))), 0, lim)
    codes = morton_codes_np(V.astype(np.int64), GS_GOLDEN_DEPTH)
    _, first = np.unique(codes, return_index=True)  # sorted by code
    attrs = np.concatenate([scene["quats"], scene["scales"],
                            scene["opacities"][:, None], scene["colors"]], axis=1)
    return V[first].astype(np.int64), np.round(attrs[first] * 1024.0) / 1024.0


# A seeded dataset sequence at 8iVFBv2 scale: three jittered sphere shells,
# each frame shifted one voxel along x from the one before. At J=10,
# 1 500 000 points a frame and seed 0, a frame holds about 0.8 M unique
# voxels (an 8iVFBv2 vox10 frame's size), a few hundred more or fewer from
# frame to frame.
DATASET_CENTERS = ((0.2, 0.2, 0.5), (0.75, 0.3, 0.5), (0.5, 0.75, 0.5))
DATASET_RADII = (0.168, 0.124, 0.09)
DATASET_POINTS = 1_500_000


def dataset_frame(frame: int, n_points: int = DATASET_POINTS, depth: int = 10,
                  seed: int = 0):
    """Frame ``frame`` of the seeded dataset sequence: ``n_points`` points on
    three jittered sphere shells (``DATASET_RADII``, in units of the grid's
    width), floored to the ``2**depth`` grid, shifted ``frame`` voxels along
    x and deduplicated (a voxel keeps its first point's colour). Returns
    ``(V (n, 3) int64, rgb (n, 3) int64)``, Morton-sorted, with integer
    RGB that varies smoothly over the surface."""
    rng = np.random.default_rng([seed, frame])
    centers = np.asarray(DATASET_CENTERS)
    radii = np.asarray(DATASET_RADII)
    area = radii ** 2
    k = rng.choice(len(radii), size=n_points, p=area / area.sum())
    d = rng.normal(size=(n_points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radii[k] * (1.0 + SURFACE_JITTER * rng.standard_normal(n_points))
    pts = centers[k] + r[:, None] * d
    g = 1 << depth
    V = np.clip(np.floor(pts * g).astype(np.int64) + np.array([frame, 0, 0]), 0, g - 1)
    _, first = np.unique(morton_codes_np(V, depth), return_index=True)
    phase = np.array([0.0, 2.1, 4.2])
    rgb = np.round(127.5 * (1.0 + np.sin(6.0 * np.pi * pts[first, :1] + 4.0 * d[first]
                                         + phase)))
    return V[first], np.clip(rgb, 0, 255).astype(np.int64)


def write_binary_ply(path, pts, rgb=None, width=None) -> None:
    """A binary-little-endian PLY: x y z float[, red green blue uchar], with
    the 8i header's ``comment width`` (``2**depth - 1``) when given."""
    names = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if rgb is not None:
        names += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(len(pts), dtype=names)
    for i, c in enumerate("xyz"):
        rec[c] = pts[:, i]
    if rgb is not None:
        for i, c in enumerate(("red", "green", "blue")):
            rec[c] = rgb[:, i]
    head = "ply\nformat binary_little_endian 1.0\n"
    if width is not None:
        head += f"comment width {width}\n"
    head += f"element vertex {len(pts)}\n"
    head += "".join(f"property {'float' if t == '<f4' else 'uchar'} {n}\n" for n, t in names)
    with open(path, "wb") as f:
        f.write((head + "end_header\n").encode())
        rec.tofile(f)
