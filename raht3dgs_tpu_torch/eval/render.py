"""Rendering comparison for 3DGS quality evaluation.

Counterpart of ``raht3dgs_tpu/eval/render.py``, on CUDA unless the caller
passes ``device="cpu"``. Backends, by the JAX package's names, so that
command lines and CSV consumers stay the same:

1. ``gsplat``: gsplat's CUDA rasterizer when it is installed (an optional
   dependency, as in the reference, ``quality_eval.py:283-353,519-521``).
2. ``jax``: the package's own volumetric 3DGS rasterizer
   (``eval/rasterize.py``, PyTorch here; the name is kept from the JAX
   package, where it means the same rasterizer). ``auto`` takes it when
   gsplat is absent.
3. ``preview``: a z-buffered point-splat renderer (fast, approximate).
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from raht3dgs_tpu_torch.eval import rasterize
from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras
from raht3dgs_tpu_torch.eval.metrics import image_psnr
from raht3dgs_tpu_torch.utils.device import DeviceLike, resolve_device

SH_C0 = 0.28209479177387814  # Y_00 normalization (standard 3DGS color mapping)


def _point_render(means, colors_dc, opacities, viewmat, K, width: int, height: int):
    """Z-buffered point splat: the nearest Gaussian wins each pixel. With
    equal depths at one pixel the writer is unspecified, as in the JAX
    package."""
    n = means.shape[0]
    ones = torch.ones((n, 1), dtype=means.dtype, device=means.device)
    cam = torch.cat([means, ones], dim=1) @ viewmat.T  # (N, 4)
    z = cam[:, 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    uvw = cam[:, :3] @ K.T
    # floor (not truncation, which would pull (-1, 0) onto the first row or
    # column), cast as XLA casts (rasterize._floor_index)
    u = rasterize._floor_index(uvw[:, 0] / zs, width)
    v = rasterize._floor_index(uvw[:, 1] / zs, height)
    inside = valid & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    inside &= opacities > 0.01
    n_pix = width * height
    pix = torch.where(inside, v.to(torch.int64) * width + u, n_pix)  # overflow bin

    zkey = torch.where(inside, z, torch.full_like(z, float("inf")))
    zmin = torch.full((n_pix + 1,), float("inf"), dtype=z.dtype, device=z.device)
    zmin = zmin.scatter_reduce(0, pix, zkey, reduce="amin", include_self=True)
    winner = inside & (zkey <= zmin[pix])

    rgb = torch.clamp(0.5 + SH_C0 * colors_dc, 0.0, 1.0)
    img = torch.ones((n_pix + 1, 3), dtype=means.dtype, device=means.device)  # white bg
    img.index_put_((torch.where(winner, pix, n_pix),),
                   torch.where(winner[:, None], rgb, torch.ones_like(rgb)))
    return img[:n_pix].reshape(height, width, 3)


def point_render(params: Dict[str, np.ndarray], viewmats, Ks, width, height,
                 device: DeviceLike = None):
    """Render all views with the preview renderer. colors: (N, C) SH with
    DC in the first 3 channels."""
    dev = resolve_device(device)
    f32 = torch.float32
    means = torch.as_tensor(np.asarray(params["means"]), dtype=f32, device=dev)
    dc = torch.as_tensor(np.asarray(params["colors"])[:, :3], dtype=f32, device=dev)
    opac = torch.as_tensor(np.asarray(params["opacities"]), dtype=f32, device=dev).reshape(-1)
    out = []
    for i in range(len(viewmats)):
        img = _point_render(means, dc, opac,
                            torch.as_tensor(viewmats[i], dtype=f32, device=dev),
                            torch.as_tensor(Ks[i], dtype=f32, device=dev), width, height)
        out.append(img.cpu().numpy())
    return np.stack(out)


def volumetric_render(params: Dict[str, np.ndarray], viewmats, Ks, width, height,
                      max_retries: int = 2, device: DeviceLike = None):
    """Render all views with the package's volumetric rasterizer.

    Returns images (V, H, W, 3). Views whose capacity limits overflow are
    rendered again with 4x the overflowing capacity, up to
    ``max_retries`` times; a warning is raised only if overflow persists.
    The scene (numpy arrays, or tensors) goes to the device once, in
    float32 (the rasterizer's precision), for every view and retry."""
    dev = resolve_device(device)
    f32 = torch.float32
    scene = {k: torch.as_tensor(params[k], dtype=f32, device=dev)
             for k in ("means", "quats", "scales", "opacities", "colors")}
    opac = scene["opacities"].reshape(-1)
    out = []
    dup_clipped = 0
    tile_clipped = 0
    for i in range(len(viewmats)):
        caps = dict(max_tiles_per_gauss=32, max_per_tile=1024)
        for attempt in range(max_retries + 1):
            img, meta = rasterize.rasterize_gaussians(
                scene["means"], scene["quats"], scene["scales"], opac, scene["colors"],
                viewmats[i], Ks[i], width, height, **caps)
            rasterize.count("syncs")
            dup, tile = torch.stack([meta.dup_clipped, meta.tile_clipped]).tolist()
            if (not dup and not tile) or attempt == max_retries:
                break
            if dup:
                caps["max_tiles_per_gauss"] *= 4
            if tile:
                caps["max_per_tile"] *= 4
        dup_clipped += dup
        tile_clipped += tile
        out.append(img)
    if dup_clipped or tile_clipped:
        warnings.warn(
            f"rasterizer capacity overflow after retries: {dup_clipped} "
            f"footprint entries, {tile_clipped} tile entries dropped — raise "
            "max_tiles_per_gauss/max_per_tile for exact images"
        )
    return np.stack(out)


def _try_gsplat_render(params, viewmats, Ks, width, height):
    import gsplat  # noqa: F401  (optional CUDA dependency)

    dev = "cuda"
    means = torch.as_tensor(params["means"], dtype=torch.float32, device=dev)
    quats = torch.as_tensor(params["quats"], dtype=torch.float32, device=dev)
    scales = torch.as_tensor(params["scales"], dtype=torch.float32, device=dev)
    opac = torch.as_tensor(params["opacities"], dtype=torch.float32, device=dev).reshape(-1)
    colors = torch.as_tensor(params["colors"], dtype=torch.float32, device=dev)
    K_sh = colors.shape[1] // 3
    sh_degree = int(np.sqrt(K_sh) - 1) if colors.shape[1] % 3 == 0 else None
    colors_r = colors.reshape(-1, K_sh, 3)
    imgs = []
    for i in range(len(viewmats)):
        renders, _, _ = gsplat.rasterization(
            means=means,
            quats=quats / quats.norm(dim=-1, keepdim=True),
            scales=scales,
            opacities=opac,
            colors=colors_r,
            viewmats=torch.as_tensor(viewmats[i: i + 1], dtype=torch.float32, device=dev),
            Ks=torch.as_tensor(Ks[i: i + 1], dtype=torch.float32, device=dev),
            width=width,
            height=height,
            sh_degree=sh_degree,
            packed=False,
            backgrounds=torch.ones((1, 3), device=dev),
        )
        imgs.append(renders[0].detach().cpu().numpy())
    return np.stack(imgs)


def render_comparison(
    original: Dict[str, np.ndarray],
    reconstructed: Dict[str, np.ndarray],
    n_views: int = 5,
    image_size: int = 512,
    seed: int = 0,
    output_dir: Optional[str] = None,
    backend: str = "auto",
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Render both scenes from shared random views and report PSNR stats
    (the reference's ``try_render_comparison``, ``quality_eval.py:373-526``).

    backend: 'auto' (gsplat if importable, else the package's volumetric
    rasterizer), 'gsplat', 'jax' (that rasterizer), 'preview' or 'none'.
    """
    if backend == "none":
        return {}
    if backend not in ("auto", "gsplat", "jax", "preview"):
        raise ValueError(
            f"unknown render backend {backend!r} "
            "(choose auto/gsplat/jax/preview/none)"
        )
    means = np.asarray(original["means"])
    center = means.mean(axis=0)
    radius = float((means.max(axis=0) - means.min(axis=0)).max()) * 1.5
    viewmats, Ks, W, H = generate_random_cameras(
        center, radius, n_views, image_size, image_size, seed=seed
    )

    use = backend
    if backend in ("auto", "gsplat"):
        try:
            t0 = time.perf_counter()
            imgs_o = _try_gsplat_render(original, viewmats, Ks, W, H)
            t_orig = time.perf_counter() - t0
            t0 = time.perf_counter()
            imgs_r = _try_gsplat_render(reconstructed, viewmats, Ks, W, H)
            t_rec = time.perf_counter() - t0
            use = "gsplat"
        except Exception as e:  # gsplat absent or failing: the documented fallback
            if backend == "gsplat":
                warnings.warn(f"gsplat rendering unavailable: {e}")
                return {}
            use = "jax"
    if use in ("jax", "preview"):
        render = volumetric_render if use == "jax" else point_render
        t0 = time.perf_counter()
        imgs_o = render(original, viewmats, Ks, W, H, device=device)
        t_orig = time.perf_counter() - t0
        t0 = time.perf_counter()
        imgs_r = render(reconstructed, viewmats, Ks, W, H, device=device)
        t_rec = time.perf_counter() - t0

    psnrs = [image_psnr(imgs_o[i], imgs_r[i]) for i in range(n_views)]
    if output_dir is not None:
        _save_views(output_dir, imgs_o, imgs_r)
    finite = [p for p in psnrs if np.isfinite(p)]
    return {
        "backend": use,
        "psnr_per_view": psnrs,
        "psnr_avg": float(np.mean(finite)) if finite else float("inf"),
        "psnr_std": float(np.std(finite)) if finite else 0.0,
        "psnr_min": float(np.min(psnrs)),
        "psnr_max": float(np.max(psnrs)),
        "original_render_time_ms": t_orig * 1000,
        "merged_render_time_ms": t_rec * 1000,
    }


def _save_views(output_dir, imgs_o, imgs_r):
    from pathlib import Path

    from raht3dgs_tpu_torch.io.png import write_png

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(len(imgs_o)):
        a = (np.clip(imgs_o[i], 0, 1) * 255).astype(np.uint8)
        b = (np.clip(imgs_r[i], 0, 1) * 255).astype(np.uint8)
        write_png(out / f"view_{i:03d}_original.png", a)
        write_png(out / f"view_{i:03d}_merged.png", b)
        write_png(out / f"view_{i:03d}_comparison.png", np.concatenate([a, b], axis=1))
