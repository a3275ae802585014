"""Random evaluation cameras on a sphere around the scene.

The port's own copy of ``raht3dgs_tpu/eval/cameras.py`` (numpy; the port
imports nothing of the JAX package), byte-equal arrays for the same seed.
It mirrors the reference's camera sampler (``quality_eval.py:205-280``):
azimuth uniform in [0, 2pi), elevation in the middle band [pi/4, 3pi/4]
(poles avoided), look-at world-to-camera matrices with +Z forward, pinhole
intrinsics with focal = 1.2 * width; seeded and vectorized in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def look_at_w2c(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    forward = target - cam_pos
    forward = forward / np.linalg.norm(forward)
    world_up = np.array([0.0, 1.0, 0.0])
    right = np.cross(world_up, forward)
    if np.linalg.norm(right) < 1e-3:
        world_up = np.array([0.0, 0.0, 1.0])
        right = np.cross(world_up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    w2c = np.eye(4)
    w2c[0, :3] = right
    w2c[1, :3] = up
    w2c[2, :3] = forward
    w2c[:3, 3] = -w2c[:3, :3] @ cam_pos
    return w2c


def generate_random_cameras(
    center: np.ndarray,
    radius: float,
    n_views: int = 5,
    image_width: int = 512,
    image_height: int = 512,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Returns (viewmats (V,4,4), Ks (V,3,3), width, height)."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, dtype=np.float64)
    viewmats = np.empty((n_views, 4, 4))
    for i in range(n_views):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(0.25, 0.75) * np.pi
        pos = center + radius * np.array(
            [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)]
        )
        viewmats[i] = look_at_w2c(pos, center)
    focal = image_width * 1.2
    K = np.array(
        [[focal, 0, image_width / 2], [0, focal, image_height / 2], [0, 0, 1]]
    )
    return viewmats, np.repeat(K[None], n_views, axis=0), image_width, image_height
