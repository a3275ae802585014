"""Seeded synthetic voxel frames in numpy (no device, no JAX).

The port's own copies of the helpers the JAX package keeps in
``ops/prelude.py:morton_codes_np``, ``tests/conftest.py:unique_voxel_cloud``
and ``__graft_entry__.py:_synthetic_frame``, so that tests and
``chip_smoke.py`` build the same frames from the same seeds.
"""

from __future__ import annotations

import numpy as np


def morton_codes_np(Vint: np.ndarray, depth: int) -> np.ndarray:
    """Morton codes of integer coordinates, digit ``z + 2y + 4x`` per level
    (bit layout of ``ops/morton.py``), int64."""
    V = np.asarray(Vint).astype(np.int64)
    M = np.zeros(V.shape[0], dtype=np.int64)
    for i in range(depth):
        b = (V >> i) & 1
        digit = b[:, 2] + (b[:, 1] << 1) + (b[:, 0] << 2)
        M |= digit << (3 * i)
    return M


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
