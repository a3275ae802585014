"""Views of one scene rendered over a mesh axis.

Counterpart of ``raht3dgs_tpu/parallel/render.py``. Views are independent,
so they shard over the devices of a mesh axis with nothing crossing between
devices but the inputs and the images: the Gaussians are copied to every
device of ``mesh[axis]``, the cameras are padded to a multiple of the axis
size with copies of the last view and split over it, and each device
renders its views one at a time through the single-view tiled rasterizer
(``eval/rasterize.py:_rasterize_tiled``) with its device current. The
images are gathered on the axis's first device; each is bitwise the
single-device render of its view when the devices are of one kind.
:func:`render_views` is the one-device loop that ``models/serving.py``
shares.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from raht3dgs_tpu_torch.eval.rasterize import RasterMeta, _colors_to_sh, _rasterize_tiled
from raht3dgs_tpu_torch.parallel.sharding import Mesh, _on, make_mesh
from raht3dgs_tpu_torch.utils import timing

F32 = torch.float32


def render_views(scene, viewmats, Ks, bg, *, width, height, sh_degree, tile,
                 max_tiles_per_gauss, max_per_tile, chunk):
    """The single-view rasterizer over (V, 4, 4) cameras on the scene's
    device, one view at a time, each in the span ``render``: ``scene`` is
    (means, quats, scales, opacities, SH colours (N, K, 3)). Returns
    (images (V, H, W, 3), dup_clipped (V,), tile_clipped (V,))."""
    means, quats, scales, opac, colors = scene
    imgs, dups, tiles = [], [], []
    for vm, Km in zip(viewmats, Ks):
        with timing.span("render"):
            img, meta = _rasterize_tiled(
                means, quats, scales, opac, colors, vm, Km, bg, width=width, height=height,
                sh_degree=sh_degree, tile=tile, max_tiles_per_gauss=max_tiles_per_gauss,
                max_per_tile=max_per_tile, chunk=chunk)
        imgs.append(img)
        dups.append(meta.dup_clipped)
        tiles.append(meta.tile_clipped)
    return torch.stack(imgs), torch.stack(dups), torch.stack(tiles)


def _pad_views(viewmats, Ks, n: int):
    """(V, 4, 4) and (V, 3, 3) cameras (arrays or tensors) as float32 numpy,
    padded to a multiple of ``n`` with copies of the last view; and V."""
    vms, Kms = (torch.as_tensor(c).to(F32).cpu().numpy() for c in (viewmats, Ks))
    V = len(vms)
    V_pad = -(-V // n) * n
    if V_pad != V:
        vms = np.concatenate([vms, np.repeat(vms[-1:], V_pad - V, axis=0)])
        Kms = np.concatenate([Kms, np.repeat(Kms[-1:], V_pad - V, axis=0)])
    return vms, Kms, V


def render_sharded(devices: Sequence[torch.device], scene_on: Callable, viewmats, Ks, bg,
                   *, image_dtype=F32, **raster):
    """Every device of ``devices`` renders its share of the (padded) views
    of the scene ``scene_on(device)`` gives it, with the device current;
    uint8 images are quantized there (``clip(img, 0, 1) * 255``, truncated)
    before they travel. Returns the first V views' (images, dup_clipped,
    tile_clipped) on the first device."""
    vms, Kms, V = _pad_views(viewmats, Ks, len(devices))
    per = len(vms) // len(devices)
    first = devices[0]
    parts = []
    for s, dev in enumerate(devices):
        with _on(dev):
            views = slice(s * per, (s + 1) * per)
            imgs, dups, tiles = render_views(
                scene_on(dev), torch.as_tensor(vms[views], device=dev),
                torch.as_tensor(Kms[views], device=dev),
                torch.as_tensor(bg, dtype=F32, device=dev), **raster)
            if image_dtype != F32:
                imgs = (torch.clip(imgs, 0.0, 1.0) * 255.0).to(image_dtype)
        parts.append((imgs, dups, tiles))
    return tuple(torch.cat([p[f].to(first) for p in parts])[:V] for f in range(3))


def render_views_sharded(
    means,
    quats,
    scales,
    opacities,
    colors,
    viewmats,
    Ks,
    width: int,
    height: int,
    sh_degree: Optional[int] = None,
    background: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
    tile: int = 16,
    max_tiles_per_gauss: int = 32,
    max_per_tile: int = 1024,
    chunk: int = 128,
) -> Tuple[torch.Tensor, RasterMeta]:
    """Render all views of one scene, views sharded over ``mesh[axis]``
    (every visible card on dp by default).

    Same per-view semantics as ``eval.rasterize.rasterize_gaussians``
    (images are the same program's bits). ``viewmats`` (V, 4, 4) and
    ``Ks`` (V, 3, 3) shard; the Gaussian parameters are copied to every
    device of the axis. V is padded to a multiple of the axis size (padding
    views are rendered and dropped). Returns (images (V, H, W, 3),
    RasterMeta with per-view overflow counts, (V,) each), on the axis's
    first device."""
    if mesh is None:
        mesh = make_mesh()
    sh, inferred = _colors_to_sh(torch.as_tensor(colors))
    params = [torch.as_tensor(a) for a in (means, quats, scales, opacities)]

    def scene_on(dev):
        m, q, s, o = (a.to(dev, F32) for a in params)
        return m, q, s, o.reshape(-1), sh.to(dev, F32)

    bg = np.ones(3, np.float32) if background is None else np.asarray(background, np.float32)
    imgs, dups, tiles = render_sharded(
        mesh.axis_devices(axis), scene_on, viewmats, Ks, bg, width=width, height=height,
        sh_degree=inferred if sh_degree is None else sh_degree,
        tile=tile, max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile,
        chunk=chunk)
    return imgs, RasterMeta(dups, tiles)
