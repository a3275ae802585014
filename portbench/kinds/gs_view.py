"""A 3DGS viewer: one compressed frame served as one rendered view, the
serve CLI's path for an ``.r3tc`` with ``--u8``.

Set-up draws the configuration's scenes (``kinds/gs_sweep.py``), merges
each with ``compress_to_nvox`` and encodes it at the configuration's step
with ``encode_gs_frame``, and attaches the lossless geometry section as
``encode_3dgs --code-geometry --save-streams`` does: the R3TC bytes a
viewer receives. The cameras are the serve CLI's: the orbit of ``views``
cameras its ``--seed`` (``camera_seed``) draws around the stream's bounds
(``eval/cameras.py``, focal ``1.2 * width``, radius ``radius_scale``
half-widths), one camera path for every seed of the run: the seed draws
the scenes. One unit is one
request: ``models/serving.py:serve_sequence`` over the one-frame stream
(geometry decode, host RLGR decode, upload tiers, inverse, scene build,
tiled rasterizer) at the configuration's size in uint8, until the image
is on the host. Requests alternate between the scenes and go round each
scene's orbit in the CLI's order, from the camera nearest the scene's
Gaussians: every cycle of ``2 * views`` requests opens with the
close-up views, so a window that ends inside a cycle holds them at no
less than their share of whole cycles, and the tail the viewer sees at
the close-up is in every window. The loop is closed with one client.
Work: views served.

The check holds each sampled request's image and clip counts against the
reference: the stream decoded in float64 (``reference/serve.py``) at the
set-up's voxels, its scene rendered by
``reference/raster.py`` on a seeded sample of tiles (``pixel_err_max``,
``pixel_err_mean``, in 8-bit levels), and the view's clip totals
(``clip_diff``: the two totals' differences over the entries the
reference bins).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.kinds import gs_sweep
from portbench.reference import codec as refcodec
from portbench.reference import entropy, raster, serve
from portbench.reference import gs as refgs


def _cameras(cfg, vmin, width: float):
    from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras

    center = np.asarray(vmin, np.float64) + width / 2.0
    vms, Ks, _, _ = generate_random_cameras(
        center, cfg["radius_scale"] * width / 2.0, n_views=cfg["views"],
        image_width=cfg["width"], image_height=cfg["height"], seed=cfg["camera_seed"])
    return vms, Ks


def _orbit(vms, centres: np.ndarray) -> np.ndarray:
    """The cameras' indices in their order round the orbit, starting at
    the camera nearest a point of ``centres (n, 3)``."""
    pos = [-vm[:3, :3].T @ vm[:3, 3] for vm in vms]
    near = [float(np.min(np.sum((centres - p) ** 2, axis=1))) for p in pos]
    return np.roll(np.arange(len(vms)), -int(np.argmin(near)))


def setup(ctx):
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    cfg, dev = ctx.cfg, ctx.device
    depth = cfg["depth"]
    codec = AttributeCodec(depth, dtype=getattr(torch, cfg["dtype"]), device=dev)
    scenes = []
    for scene in gs_sweep.make_scenes(ctx, dev):
        c = compress_to_nvox(scene, depth=depth, device=dev)
        V = c.positions_int[:c.n_voxels]
        width = float(c.voxel_size) * (1 << depth)
        (pt,) = encode_gs_frame(V, gs_sweep.payload(c), depth=depth, steps=[cfg["step"]],
                                bucket=cfg["bucket"], dtype=getattr(torch, cfg["dtype"]),
                                keep_streams=True, codec=codec, vmin=c.vmin, width=width,
                                device=dev)
        stream = pt.encoded.stream
        stream.geometry = geometry_from_positions(V, depth)
        vms, Ks = _cameras(cfg, stream.vmin, float(stream.width))
        centres = (V + 0.5) * float(c.voxel_size) + np.asarray(c.vmin, np.float64)
        scenes.append({"V": V.copy(), "vmin": np.asarray(c.vmin, np.float64),
                       "voxel_size": float(c.voxel_size), "blob": stream.to_bytes(),
                       "vms": vms, "Ks": Ks, "orbit": _orbit(vms, centres)})
    state = {"scenes": scenes}
    for i in range(len(scenes)):  # every scene once: the kernels, the allocator's pools
        _serve(ctx, state, i)
    return state


def _pick(ctx, state, i: int):
    """Request ``i``'s scene and camera."""
    n = len(state["scenes"])
    k = i % n
    return k, int(state["scenes"][k]["orbit"][(i // n) % ctx.cfg["views"]])


def _serve(ctx, state, i: int):
    from raht3dgs_tpu_torch.models.serving import serve_sequence

    cfg = ctx.cfg
    k, cam = _pick(ctx, state, i)
    s = state["scenes"][k]
    frames = list(serve_sequence(
        [s["blob"]], s["vms"][cam:cam + 1], s["Ks"][cam:cam + 1], width=cfg["width"],
        height=cfg["height"], sh_degree=cfg["sh_degree"], tile=cfg["tile"],
        max_tiles_per_gauss=cfg["max_tiles_per_gauss"], max_per_tile=cfg["max_per_tile"],
        chunk=cfg["chunk"], image_dtype=torch.uint8, device=ctx.device))
    img = frames[0][0][0].cpu().numpy() if len(frames) == 1 else None
    return frames, img


def unit(ctx, state, i: int) -> None:
    cfg = ctx.cfg
    with ctx.spans("unit"):
        frames, img = _serve(ctx, state, i)
    ctx.failed += img is None or img.shape != (cfg["height"], cfg["width"], 3) \
        or img.dtype != np.uint8
    ctx.count("views", 1)
    ctx.work += 1
    slot = ctx.sample.offer()
    if slot is not None and img is not None:
        _, dups, tiles = frames[0]
        dup, tile = torch.stack([dups[0], tiles[0]]).tolist()
        k, cam = _pick(ctx, state, i)
        ctx.sample.put(slot, {"scene": k, "cam": cam, "img": img, "dup": dup, "tile": tile})


def release(state) -> None:
    pass


def reference_scene(ctx, s, dtype=torch.float64):
    """The request's stream decoded and built into a scene by the
    reference, in ``dtype`` (``reference/serve.py:served_scene``)."""
    cfg = ctx.cfg
    return serve.served_scene(s["blob"], s["V"], s["voxel_size"], s["vmin"],
                              depth=cfg["depth"], channels=cfg["channels"], step=cfg["step"],
                              dtype=dtype)


def sample_tiles(rng, view: raster.View, k: int) -> np.ndarray:
    """``k`` tiles drawn without replacement from those the view bins
    entries to (all of them, and then empty ones, where fewer)."""
    counts = view.counts.numpy()
    full, empty = np.flatnonzero(counts > 0), np.flatnonzero(counts == 0)
    take = rng.choice(full, min(k, len(full)), replace=False)
    more = rng.choice(empty, min(k - len(take), len(empty)), replace=False)
    return np.sort(np.concatenate([take, more]).astype(np.int64))


def _inside(tiles: np.ndarray, tiles_x: int, width: int, height: int) -> np.ndarray:
    """``(T, 16, 16)``: which pixels of each tile lie inside the image."""
    r = np.arange(raster.TILE)
    y = (tiles // tiles_x)[:, None, None] * raster.TILE + r[None, :, None]
    x = (tiles % tiles_x)[:, None, None] * raster.TILE + r[None, None, :]
    return (y < height) & (x < width)


def _judge(ctx, state, produce):
    """Worst numbers over the sampled requests. ``produce(kept, s, tiles)``
    gives the served ``(blocks (T, 16, 16, 3), dup_clipped,
    tile_clipped)`` of the request's tiles (blocks in 8-bit levels; pixels
    past the image's edge are not compared)."""
    cfg = ctx.cfg
    worst = {}
    refs = {}

    def put(k, v):
        worst[k] = max(worst.get(k, 0.0), float(v))

    for kept in ctx.sample.kept:
        if kept is None:  # a failed unit, counted in failed_units
            continue
        s = state["scenes"][kept["scene"]]
        if kept["scene"] not in refs:
            refs[kept["scene"]] = reference_scene(ctx, s)
        nums, scene = refs[kept["scene"]]
        for k, v in nums.items():
            put(k, v)
        if scene is None:
            continue
        cam = kept["cam"]
        view = raster.View(scene, s["vms"][cam], s["Ks"][cam], cfg["width"], cfg["height"],
                           sh_degree=cfg["sh_degree"],
                           max_tiles_per_gauss=cfg["max_tiles_per_gauss"],
                           max_per_tile=cfg["max_per_tile"])
        tiles = sample_tiles(ctx.sample.rng, view, ctx.mix["check_tiles"])
        want = raster.display_u8(view.render_tiles(tiles)).numpy().astype(np.int16)
        got, dup, tile = produce(kept, s, tiles)
        inside = _inside(tiles, view.tiles_x, cfg["width"], cfg["height"])
        err = np.abs(got.astype(np.int16) - want)[inside] if got.shape == want.shape \
            else np.array([np.inf])
        put("pixel_err_max", err.max())
        put("pixel_err_mean", err.mean())
        # a Gaussian whose float32 box edge lies within rounding of a tile
        # edge gets another box than in float64: the totals may differ by a
        # box's tiles a flip, so they are compared per entry binned
        put("clip_diff", (abs(dup - view.dup_clipped) + abs(tile - view.tile_clipped))
            / max(view.entries, 1))
    worst["failed_units"] = float(ctx.failed)
    return worst


def check(ctx, state):
    def produce(kept, s, tiles):
        return (raster.image_tiles(kept["img"], tiles, -(-ctx.cfg["width"] // raster.TILE)),
                kept["dup"], kept["tile"])

    return _judge(ctx, state, produce)


def control_sample(ctx):
    """The seed's scenes merged and encoded by the reference (float64; no
    geometry section, which the check does not read), the cameras around
    them, and ``check_units`` draws of a scene and a camera."""
    cfg = ctx.cfg
    depth = cfg["depth"]
    scenes = []
    for scene in gs_sweep.make_scenes(ctx, ctx.device):
        u, vmin, vs = refgs.voxel_coords(scene["means"], depth)
        V = np.clip(np.floor(u), 0, (1 << depth) - 1).astype(np.int64)
        P, cluster = np.unique(V, axis=0, return_inverse=True)
        r = refcodec.RefFrame(P, refgs.merge(scene, cluster.reshape(-1), len(P)), depth)
        blob = entropy.write_stream(r.symbols(float(cfg["step"])), float(cfg["step"]), depth)
        vms, Ks = _cameras(cfg, vmin, vs * (1 << depth))
        scenes.append({"V": P, "vmin": vmin, "voxel_size": vs, "blob": blob, "vms": vms,
                       "Ks": Ks})
    for _ in range(ctx.sample.k):
        ctx.sample.kept.append({"scene": int(ctx.sample.rng.integers(0, len(scenes))),
                                "cam": int(ctx.sample.rng.integers(0, cfg["views"]))})
    return {"scenes": scenes}


def control(ctx, state, dtype=torch.bfloat16):
    """The reference in ``dtype`` in the program's place: the stream's
    reconstruction, its scene and the view's projection, binning and blend,
    in ``dtype``."""
    cfg = ctx.cfg
    low = {}

    def produce(kept, s, tiles):
        if kept["scene"] not in low:
            low[kept["scene"]] = reference_scene(ctx, s, dtype)[1]
        view = raster.View(low[kept["scene"]], s["vms"][kept["cam"]], s["Ks"][kept["cam"]],
                           cfg["width"], cfg["height"], sh_degree=cfg["sh_degree"],
                           max_tiles_per_gauss=cfg["max_tiles_per_gauss"],
                           max_per_tile=cfg["max_per_tile"], dtype=dtype)
        return (raster.display_u8(view.render_tiles(tiles).double()).numpy(),
                view.dup_clipped, view.tile_clipped)

    return _judge(ctx, state, produce)
