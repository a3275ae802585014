"""3DGS serving: compressed stream -> scene on the device -> rendered views.

Counterpart of ``raht3dgs_tpu/models/serving.py``.
The serving consumer of a 3DGS codec is a renderer. Per frame the host
entropy-decodes the symbols, uploads them once through the narrowing tiers
(``pack_quantized_upload`` / ``upload_quantized``), and the device runs
dequantization, the inverse RAHT (its two compensated scans through
``ops/ds_scan.py``), the scene build and the rasterizer for every requested
view; the decoded attributes never leave the device, only the images do.
The JAX package fuses each of these into one compiled program and scans
the views with ``lax.scan``; here they are eager PyTorch ops on the frame's
device and a loop over the views.

- :func:`serve_frame` / :func:`serve_frame_predicted`: one frame, plain or
  predicted-RAHT (the NON-NORMATIVE device closed loop of
  ``ops/praht_device.py``: attributes within float ulps of the frozen host
  decode, which is harmless because they only feed the renderer).
- :func:`serve_tiled_frame`: an ``.r3tt`` tiled frame, decoding only the
  bricks the cameras can see (:func:`visible_bricks`) or a given
  selection; each brick its own inverse order, dequantization or
  predicted loop and inverse, the scenes concatenated in key order.
- :func:`serve_sequence`: ``.r3ts`` playback with the reconstruction
  resident on the device across I/P frames (non-normative display decode;
  v2 derived-motion streams are refused).

Sharded serving renders the views over the devices of a mesh axis
(``parallel/render.py``), the images gathered on its first device:
:func:`serve_views_sharded` decodes the frame on every device of the axis,
as the JAX package's replicated program does; ``serve_tiled_frame`` and
``serve_sequence`` with ``mesh=`` decode on the first device and copy the
scene to the others. Images are bitwise the unsharded call's when the
devices are of one kind.

Under a profiler (``utils/timing.py``) every frame that ``serve_frame``,
``serve_frame_predicted``, ``serve_tiled_frame`` or ``serve_sequence``
serves is a request root ``serve``, with the children ``geometry``
(positions from the stream's geometry section and the padded frame),
``rlgr_decode`` (the host entropy decode), ``upload`` (the narrowing
pack and the upload), ``inverse`` (inverse order, dequantization, the
inverse RAHT and the scene build) and ``render`` (one a view, with the
rasterizer's ``project``, ``bin`` and ``blend`` under it).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raht3dgs_tpu_torch.models.pipeline import (  # noqa: F401  (re-exported)
    _dequant_gather_device,
    _inverse_order_device,
    decode_entropy_channels,
    pack_quantized_upload,
    quantized_upload_array,
    upload_quantized,
)
from raht3dgs_tpu_torch.models.pipeline import _NP_CODE
from raht3dgs_tpu_torch.ops.morton import (
    code_dtype,
    flipped_tier,
    internal_payload_bits,
    morton_codes_np,
)
from raht3dgs_tpu_torch.ops.morton import morton_decode
from raht3dgs_tpu_torch.ops.praht_device import praht_device_decode, praht_device_plan
from raht3dgs_tpu_torch.ops.raht_span import raht_inverse_span, raht_structure_span
from raht3dgs_tpu_torch.parallel.render import render_sharded
from raht3dgs_tpu_torch.parallel.render import render_views as _render_views
from raht3dgs_tpu_torch.utils import timing
from raht3dgs_tpu_torch.utils.device import (
    DeviceLike,
    device_of,
    resolve_device,
    to_device,
)

__all__ = [
    "decode_scene_device",
    "decode_scene_device_predicted",
    "serve_frame",
    "serve_frame_predicted",
    "serve_sequence",
    "serve_tiled_frame",
    "serve_views_sharded",
    "visible_bricks",
    "quantized_upload_array",
    "pack_quantized_upload",
    "upload_quantized",
    "build_inverse_order",
]

build_inverse_order = _inverse_order_device

F32 = torch.float32


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(F32)


def _steps_f32(steps, dev) -> torch.Tensor:
    return _f32(np.atleast_1d(np.asarray(steps, dtype=np.float32)), dev)


def _scene_from_attrs(attrs, codes, weights, voxel_size, vmin, depth):
    """(means, quats, scales, opacities, SH colours) of the 56-channel 3DGS
    packing (quats 0:4, scales 4:7, opacity 7, SH colours 8:); padding slots
    (weight 0) get opacity 0."""
    dev = attrs.device
    means = (morton_decode(codes, depth).to(F32) + 0.5) * _f32(voxel_size, dev) \
        + _f32(vmin, dev)[None, :]
    quats = attrs[:, 0:4]
    scales = torch.clamp(attrs[:, 4:7], min=1e-5)
    opac = torch.clip(attrs[:, 7], 0.0, 1.0) * (weights > 0)
    colors = attrs[:, 8:].reshape(attrs.shape[0], -1, 3)
    return means, quats, scales, opac, colors


def _dequant_inverse(vals_T, inv, steps, codes, weights, depth, quant_mode, rec_delta):
    dev = codes.device
    coeffs = _dequant_gather_device(vals_T.to(torch.int32), inv, steps, F32, quant_mode,
                                    torch.tensor(rec_delta, dtype=F32, device=dev))
    return raht_inverse_span(coeffs, codes, weights, depth)


def _predicted_attrs(plan, vals_T, inv, predict_mask, steps, codes, weights, depth,
                     quant_mode, rec_delta):
    sym = vals_T.to(torch.int32).T[inv.long()]
    return praht_device_decode(plan, codes, weights, sym, int(predict_mask), depth, steps,
                               quant_mode=quant_mode, rec_delta=rec_delta, fdtype=F32)


def _plan_of(codes, weights, depth):
    """The predicted loop's device plan from the decoder's structure pass."""
    structure = raht_structure_span(codes, weights, depth)
    return praht_device_plan(codes, weights, depth, structure.drop_level,
                             structure.subtree_w)


def _device_args(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def decode_scene_device(vals_T, inv, steps, codes, weights, voxel_size, vmin, *,
                        depth: int, quant_mode: str = "mid", rec_delta=0.0,
                        device: DeviceLike = None):
    """Quantized (D, N) channel matrix -> reconstructed 3DGS scene on the
    device of ``codes`` (or ``device``: CUDA unless ``"cpu"``).
    ``quant_mode`` / ``rec_delta`` are the stream's quantizer: "deadzone"
    reconstructs at ``sign(q)*(|q|+delta)*step``."""
    dev = device_of(codes, device)
    vals_T, inv, codes, weights = _device_args(dev, vals_T, inv, codes, weights)
    attrs = _dequant_inverse(vals_T, inv, _f32(steps, dev), codes, weights, depth,
                             quant_mode, rec_delta)
    return _scene_from_attrs(attrs, codes, weights, voxel_size, vmin, depth)


def decode_scene_device_predicted(vals_T, inv, plan, predict_mask, steps, codes, weights,
                                  voxel_size, vmin, *, depth: int, quant_mode: str = "mid",
                                  rec_delta=0.12, device: DeviceLike = None):
    """Predicted-RAHT stream -> 3DGS scene through the NON-NORMATIVE device
    closed loop (``ops/praht_device.py:praht_device_decode``): within float
    ulps of the frozen host decode, for serving only. ``plan`` is the
    frame's :class:`ops.praht_device.PrahtDevicePlan`."""
    dev = device_of(codes, device)
    vals_T, inv, codes, weights = _device_args(dev, vals_T, inv, codes, weights)
    attrs = _predicted_attrs(plan, vals_T, inv, predict_mask, _f32(steps, dev), codes,
                             weights, depth, quant_mode, rec_delta)
    return _scene_from_attrs(attrs, codes, weights, voxel_size, vmin, depth)


def _render_scene_views(scene, viewmats, Ks, bg, *, width, height, sh_degree=3, tile=16,
                        max_tiles_per_gauss=16, max_per_tile=8192, chunk=128,
                        image_dtype=torch.float32):
    """Render V views of a scene already on the device; ``image_dtype=
    torch.uint8`` quantizes there with the display convention
    (``clip(img, 0, 1) * 255``, truncated)."""
    dev = scene[0].device
    bg = _f32(np.ones(3) if bg is None else bg, dev)
    imgs, dups, tiles = _render_views(
        scene, _f32(viewmats, dev), _f32(Ks, dev), bg, width=width, height=height,
        sh_degree=sh_degree, tile=tile, max_tiles_per_gauss=max_tiles_per_gauss,
        max_per_tile=max_per_tile, chunk=chunk)
    if image_dtype != torch.float32:
        imgs = (torch.clip(imgs, 0.0, 1.0) * 255.0).to(image_dtype)
    return imgs, dups, tiles


def _render_on(devices, scene, viewmats, Ks, bg, **kw):
    """:func:`_render_scene_views` on the scene's device, or with
    ``devices`` the views sharded over them, the scene copied to each."""
    if devices is None:
        return _render_scene_views(scene, viewmats, Ks, bg, **kw)
    return render_sharded(devices, lambda d: tuple(t.to(d) for t in scene), viewmats, Ks,
                          np.ones(3) if bg is None else bg, **kw)


@timing.spanned("serve")
def serve_frame(vals_T, inv, steps, codes, weights, voxel_size, vmin, viewmats, Ks, bg=None,
                *, depth: int, width: int, height: int, sh_degree: int = 3, tile: int = 16,
                max_tiles_per_gauss: int = 16, max_per_tile: int = 8192, chunk: int = 128,
                image_dtype=torch.float32, quant_mode: str = "mid", rec_delta=0.0,
                device: DeviceLike = None):
    """Decode one frame on the device and render all V views.

    Returns (images (V, H, W, 3), dup_clipped (V,), tile_clipped (V,)).
    ``image_dtype=torch.uint8`` quantizes the images on the device
    (``clip(img, 0, 1) * 255``) so a fetch moves a quarter of the bytes;
    keep float32 for evaluation (PSNR is defined on the float render)."""
    with timing.span("inverse"):
        scene = decode_scene_device(vals_T, inv, steps, codes, weights, voxel_size, vmin,
                                    depth=depth, quant_mode=quant_mode, rec_delta=rec_delta,
                                    device=device)
    return _render_scene_views(
        scene, viewmats, Ks, bg, width=width, height=height, sh_degree=sh_degree,
        tile=tile, max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile,
        chunk=chunk, image_dtype=image_dtype)


@timing.spanned("serve")
def serve_frame_predicted(vals_T, inv, plan, predict_mask, steps, codes, weights, voxel_size,
                          vmin, viewmats, Ks, bg=None, *, depth: int, width: int,
                          height: int, sh_degree: int = 3, tile: int = 16,
                          max_tiles_per_gauss: int = 16, max_per_tile: int = 8192,
                          chunk: int = 128, image_dtype=torch.float32,
                          quant_mode: str = "mid", rec_delta=0.12,
                          device: DeviceLike = None):
    """:func:`serve_frame` for predicted-RAHT streams: the closed-loop decode
    runs on the device (non-normative, serving only; see
    :func:`decode_scene_device_predicted`)."""
    with timing.span("inverse"):
        scene = decode_scene_device_predicted(
            vals_T, inv, plan, predict_mask, steps, codes, weights, voxel_size, vmin,
            depth=depth, quant_mode=quant_mode, rec_delta=rec_delta, device=device)
    return _render_scene_views(
        scene, viewmats, Ks, bg, width=width, height=height, sh_degree=sh_degree,
        tile=tile, max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile,
        chunk=chunk, image_dtype=image_dtype)


def serve_views_sharded(vals_T, inv, steps, codes, weights, voxel_size, vmin, viewmats, Ks,
                        bg=None, *, mesh, depth: int, width: int, height: int,
                        sh_degree: int = 3, axis: str = "dp", tile: int = 16,
                        max_tiles_per_gauss: int = 16, max_per_tile: int = 8192,
                        chunk: int = 128, image_dtype=torch.float32, quant_mode: str = "mid",
                        rec_delta=0.0):
    """:func:`serve_frame` with the views sharded over ``mesh[axis]``: every
    device of the axis decodes the frame itself (nothing is broadcast) and
    renders its share of the views, V padded to a multiple of the axis size
    (padding views rendered and dropped). Returns (images (V, H, W, 3),
    dup_clipped (V,), tile_clipped (V,)) on the axis's first device."""

    def scene_on(dev):
        return decode_scene_device(vals_T, inv, steps, codes, weights, voxel_size, vmin,
                                   depth=depth, quant_mode=quant_mode, rec_delta=rec_delta,
                                   device=dev)

    return render_sharded(
        mesh.axis_devices(axis), scene_on, viewmats, Ks, np.ones(3) if bg is None else bg,
        width=width, height=height, sh_degree=sh_degree, tile=tile,
        max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile, chunk=chunk,
        image_dtype=image_dtype)


def _padded_frame_np(Vt, depth: int, P: int):
    """Sorted real Morton codes + pad sentinels and 0/1 weights for ``P``
    slots, in numpy: ``prepare_voxel_frame``'s layout (pad slots ``arange(n,
    P)`` above ``1 << payload bits``) without a device round trip. The
    sentinels are built in the code dtype (a Python ``1 << 63`` added to an
    int64 arange would overflow); at depth 21 the codes take the flipped
    int64 form of ``ops/morton.py``, whose sentinel ``(1 << 63) + slot`` is
    the slot itself."""
    cdt = np.dtype(_NP_CODE[code_dtype(depth, P)])
    codes_t = np.sort(morton_codes_np(np.asarray(Vt, np.int64), depth))
    n_t = len(codes_t)
    pads = np.arange(n_t, P, dtype=np.int64).astype(cdt)
    if flipped_tier(depth):
        codes_t = codes_t ^ np.int64(-(1 << 63))
    else:
        pads += cdt.type(1 << internal_payload_bits(depth, P))
    codes_p = np.concatenate([codes_t.astype(cdt), pads])
    w_p = np.zeros(P, dtype=np.float32)
    w_p[:n_t] = 1.0
    return codes_p, w_p


def visible_bricks(reader, viewmats, Ks, width, height, *, voxel_size=None, vmin=None,
                   near=1e-6, margin=0.0):
    """Conservative frustum cull over a tiled frame's bricks (numpy, float64).

    Returns the ascending tile indices whose world-space box (the brick's
    voxel extent scaled by ``voxel_size`` / ``vmin``, widened by ``margin``
    world units on every side) projects into at least one view's image. A
    brick's Gaussians spill past its voxel box: pass ~3x the largest splat
    scale for renders equal to an unculled decode; 0 culls on voxel extents
    alone. A box straddling the camera plane is kept."""
    from raht3dgs_tpu_torch.models.tiling import brick_boxes_np

    meta = reader.meta
    if voxel_size is None:
        voxel_size = float(meta.width) / (1 << reader.depth)
    if vmin is None:
        vmin = np.asarray(meta.vmin, dtype=np.float64)
    vms = np.asarray(viewmats, dtype=np.float64)
    Kms = np.asarray(Ks, dtype=np.float64)
    los, side = brick_boxes_np(reader.keys, reader.depth, reader.brick_depth)
    sel = []
    for j in range(len(los)):
        lo, hi = los[j], los[j] + side
        c0 = lo * voxel_size + vmin - margin
        c1 = hi * voxel_size + vmin + margin
        corners = np.array([
            [c0[0], c0[1], c0[2]], [c1[0], c0[1], c0[2]],
            [c0[0], c1[1], c0[2]], [c1[0], c1[1], c0[2]],
            [c0[0], c0[1], c1[2]], [c1[0], c0[1], c1[2]],
            [c0[0], c1[1], c1[2]], [c1[0], c1[1], c1[2]],
        ])
        vis = False
        for w2c, K in zip(vms, Kms):
            pc = corners @ w2c[:3, :3].T + w2c[:3, 3]
            z = pc[:, 2]
            if np.all(z <= near):
                continue  # entirely behind the camera
            if np.any(z <= near):
                vis = True  # straddles the camera plane: keep
                break
            u = K[0, 0] * pc[:, 0] / z + K[0, 2]
            v = K[1, 1] * pc[:, 1] / z + K[1, 2]
            if u.max() >= 0 and u.min() < width and v.max() >= 0 and v.min() < height:
                vis = True
                break
        if vis:
            sel.append(j)
    return sel


def _decode_bricks_device(vals_flat, codes_flat, weights_flat, nvox_K, steps, voxel_size,
                          vmin, pmask_K=None, *, depth: int, parts: tuple,
                          predicted: tuple = None, order_mode: str = "ragft",
                          quant_mode: str = "mid", rec_delta=0.0):
    """Ragged-concatenated brick symbols -> one concatenated scene.

    ``parts`` are the bricks' padded lengths, ``vals_flat`` (D, sum(parts))
    and ``codes_flat`` / ``weights_flat`` (sum(parts),) on one device. Each
    brick runs its own inverse stream order, then its dequantization and
    inverse RAHT, or (``predicted[k]``) the non-normative device predicted
    loop with its signalled mask ``pmask_K[k]``; the five scene fields are
    concatenated once, in key order. Padding slots have weight 0, hence
    opacity 0, so the concatenation keeps the global Morton order of the
    real voxels."""
    if predicted is None:
        predicted = (False,) * len(parts)
    outs, off = [], 0
    for k, Pk in enumerate(parts):
        vals_T = vals_flat[:, off:off + Pk]
        codes = codes_flat[off:off + Pk]
        weights = weights_flat[off:off + Pk]
        inv = _inverse_order_device(codes, weights, int(nvox_K[k]), depth, order_mode)
        if predicted[k]:
            attrs = _predicted_attrs(_plan_of(codes, weights, depth), vals_T, inv,
                                     pmask_K[k], steps, codes, weights, depth, quant_mode,
                                     rec_delta)
        else:
            attrs = _dequant_inverse(vals_T, inv, steps, codes, weights, depth, quant_mode,
                                     rec_delta)
        outs.append(_scene_from_attrs(attrs, codes, weights, voxel_size, vmin, depth))
        off += Pk
    return tuple(torch.cat([p[f] for p in outs], dim=0) for f in range(5))


@timing.spanned("serve")
def serve_tiled_frame(data, viewmats, Ks, bg=None, *, width, height, positions=None,
                      bricks=None, bucket=1 << 10, margin=0.0, mesh=None, axis="dp",
                      sh_degree=3, tile=16, max_tiles_per_gauss=16, max_per_tile=8192,
                      chunk=128, image_dtype=torch.float32, device: DeviceLike = None):
    """Serve views from an ``.r3tt`` tiled 3DGS frame, decoding only the
    bricks the cameras can see (:func:`visible_bricks`, widened by
    ``margin``) or those in ``bricks`` (for example
    ``TiledReader.select_roi``). Each selected brick's stream is
    entropy-decoded on the host, padded to its own multiple of ``bucket``,
    and all of them cross in one upload; the device decodes brick by brick
    (predicted bricks through the non-normative device loop), concatenates
    the scenes in key order and renders every view. Runs on CUDA unless
    ``device="cpu"``. ``mesh`` / ``axis`` shard the views over
    ``mesh[axis]``: the bricks decode once on the axis's first device, the
    scene is copied to the others, and V is padded to a multiple of the
    axis size (padding views rendered and dropped).

    Returns ``(images (V, H, W, 3), dup_clipped (V,), tile_clipped (V,),
    selected brick indices)``."""
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry
    from raht3dgs_tpu_torch.models.tiling import TiledReader, positions_by_brick

    devices = None if mesh is None else mesh.axis_devices(axis)
    dev = resolve_device(device) if devices is None else devices[0]
    reader = data if isinstance(data, TiledReader) else TiledReader(data)
    depth = reader.depth
    meta = reader.meta
    voxel_size = float(meta.width) / (1 << depth)
    vmin = np.asarray(meta.vmin, dtype=np.float64)
    sel = (list(bricks) if bricks is not None else visible_bricks(
        reader, viewmats, Ks, width, height, voxel_size=voxel_size, vmin=vmin,
        margin=margin))
    if not sel:
        raise ValueError("no brick is visible from the requested views")

    by_brick = None
    with timing.span("geometry"):
        if positions is None and reader.geometry is not None:
            positions = positions_from_geometry(reader.geometry, depth, reader.n_voxels,
                                                device=dev)
        if positions is not None:
            by_brick = positions_by_brick(positions, depth, reader.brick_depth)

        # host pass: each selected brick's stream and positions
        host = []
        for i in sorted(sel):
            stream = reader.tile(i)
            if stream.geometry is not None:
                Vt = positions_from_geometry(stream.geometry, depth, stream.n_voxels,
                                             device=dev)
            elif by_brick is not None:
                Vt = by_brick[int(reader.keys[i])]
            else:
                raise ValueError("tiles carry no geometry; pass the frame's positions")
            if len(Vt) != stream.n_voxels:
                raise ValueError(
                    f"brick {i}: {len(Vt)} positions != {stream.n_voxels} coded voxels")
            host.append((stream, np.asarray(Vt, dtype=np.int64)))

    stream0 = host[0][0]
    D = stream0.n_channels
    for st, _ in host[1:]:
        if (st.order_mode, st.quant_mode, st.rec_delta, st.n_channels,
                tuple(np.atleast_1d(st.steps))) != (
                stream0.order_mode, stream0.quant_mode, stream0.rec_delta,
                stream0.n_channels, tuple(np.atleast_1d(stream0.steps))):
            raise ValueError(
                "bricks disagree on codec parameters; serve_tiled_frame stacks them into "
                "one upload and needs uniform order/quant/steps (v2 containers "
                "guarantee this)")
    # ragged padding: each brick rounds up to its own bucket multiple, so
    # the one upload carries about the real bytes
    parts = tuple(-((-max(len(v), 1)) // bucket) * bucket for _, v in host)
    codes_K, weights_K, vals_K = [], [], []
    for (stream, Vt), Pk in zip(host, parts):
        with timing.span("geometry"):
            codes_p, w_p = _padded_frame_np(Vt, depth, Pk)
        vals_T = np.zeros((D, Pk), dtype=np.int32)
        decode_entropy_channels(stream, stream.n_voxels, vals_T)
        codes_K.append(codes_p.astype(np.int64))
        weights_K.append(w_p)
        vals_K.append(vals_T)
    cdt_all = _NP_CODE[code_dtype(depth, max(parts))]
    with timing.span("upload"):
        vals_dev = upload_quantized(pack_quantized_upload(np.concatenate(vals_K, axis=1)),
                                    device=dev)
        codes_dev = to_device(np.concatenate(codes_K).astype(cdt_all), dev)
        weights_dev = to_device(np.concatenate(weights_K), dev)
    with timing.span("inverse"):
        scene = _decode_bricks_device(
            vals_dev, codes_dev, weights_dev, [st.n_voxels for st, _ in host],
            _steps_f32(stream0.steps, dev), voxel_size, vmin,
            [st.predict_mask or 0 for st, _ in host], depth=depth, parts=parts,
            predicted=tuple(bool(st.predict) for st, _ in host),
            order_mode=stream0.order_mode, quant_mode=stream0.quant_mode,
            rec_delta=stream0.rec_delta)
    imgs, dups, tiles = _render_on(
        devices, scene, viewmats, Ks, bg, width=width, height=height, sh_degree=sh_degree,
        tile=tile, max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile,
        chunk=chunk, image_dtype=image_dtype)
    return imgs, dups, tiles, sorted(sel)


def _seq_step_body(vals_T, codes, weights, nvox, steps, mv, prev_codes, prev_attrs,
                   prev_weights, predict_mask, voxel_size, vmin, viewmats, Ks, bg, *,
                   depth: int, probes: int, order_mode: str, quant_mode: str, rec_delta=0.0,
                   width: int, height: int, sh_degree: int = 3, tile: int = 16,
                   max_tiles_per_gauss: int = 16, max_per_tile: int = 8192,
                   chunk: int = 128, image_dtype=torch.float32, devices=None):
    """One playback frame: the residual decode (the device predicted loop
    when ``predict_mask`` is not None), plus for an inter frame (``mv`` not
    None) the motion-compensated prediction from the previous frame's
    reconstruction on the device, then the scene and the V views. Returns
    ``(imgs, dups, tiles, attrs)``; ``attrs`` is the padded reconstruction
    (zero pad rows) that becomes the next frame's ``prev_attrs``. With
    ``devices`` the views are sharded over them."""
    from raht3dgs_tpu_torch.ops.temporal import predict_from_previous

    with timing.span("inverse"):
        inv = _inverse_order_device(codes, weights, nvox, depth, order_mode)
        if predict_mask is not None:
            attrs = _predicted_attrs(_plan_of(codes, weights, depth), vals_T, inv,
                                     predict_mask, steps, codes, weights, depth, quant_mode,
                                     rec_delta)
        else:
            attrs = _dequant_inverse(vals_T, inv, steps, codes, weights, depth, quant_mode,
                                     rec_delta)
        if mv is not None:
            pred, _ = predict_from_previous(codes, prev_codes, prev_attrs, prev_weights,
                                            depth, probes, mv)
            attrs = attrs + pred
        attrs = attrs * (weights > 0)[:, None]
        scene = _scene_from_attrs(attrs, codes, weights, voxel_size, vmin, depth)
    imgs, dups, tiles = _render_on(
        devices, scene, viewmats, Ks, bg, width=width, height=height, sh_degree=sh_degree,
        tile=tile, max_tiles_per_gauss=max_tiles_per_gauss, max_per_tile=max_per_tile,
        chunk=chunk, image_dtype=image_dtype)
    return imgs, dups, tiles, attrs


def serve_sequence(streams, viewmats, Ks, bg=None, *, width, height, positions=None,
                   bucket=1 << 11, progressive=0, mesh=None, axis="dp", sh_degree=3,
                   tile=16, max_tiles_per_gauss=16, max_per_tile=8192, chunk=128,
                   image_dtype=torch.float32, device: DeviceLike = None):
    """Streaming playback of a temporal sequence: a generator of per-frame
    ``(images, dup_clipped, tile_clipped)``, with the reconstruction kept on
    the device across frames (CUDA unless ``device="cpu"``).

    Per frame the host entropy-decodes the residual symbols (and the
    signalled motion section); the device runs the inverse transform, the
    motion-compensated prediction from the previous frame's attributes, the
    scene build and the V views. This is the NON-NORMATIVE device decode
    that serving may use: the reconstruction drifts from the frozen host
    loop by float32 ulps a frame, reset at every I-frame, and never feeds an
    encoder.

    Args:
        streams: a ``SequenceReader``, the path of an ``.r3ts`` file, or an
            iterable of :class:`FrameStream` (or their bytes), intra first.
        positions: per-frame voxel positions, a sequence indexed by frame
            or a callable ``i -> (N_i, 3)``; ``None`` decodes them from each
            stream's geometry section.
        bucket: the padding granularity of each frame.
        progressive: decode only the first K entropy symbols per channel
            (0 = all): a coarse preview from a stream prefix. All-intra
            sequences only (a cut residual would corrupt the prediction
            chain).
        mesh/axis: shard each frame's views over ``mesh[axis]``; the
            reconstruction stays on the axis's first device and each
            frame's scene is copied to the others. V is padded to a
            multiple of the axis size (padding views rendered and dropped).

    Predicted-RAHT streams run the device predicted loop on their
    (residual) symbols. v2 derived-motion inter streams are refused: their
    prediction is the frozen host pipeline; decode those with
    ``SequenceCodec.decode_sequence``."""
    devices = None if mesh is None else mesh.axis_devices(axis)
    dev = resolve_device(device) if devices is None else devices[0]
    return _serve_sequence(streams, viewmats, Ks, bg, dev, devices, width=width, height=height,
                           positions=positions, bucket=bucket, progressive=progressive,
                           sh_degree=sh_degree, tile=tile,
                           max_tiles_per_gauss=max_tiles_per_gauss,
                           max_per_tile=max_per_tile, chunk=chunk, image_dtype=image_dtype)


def _serve_sequence(streams, viewmats, Ks, bg, dev, devices, *, width, height, positions,
                    bucket, progressive, **raster):
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream, SequenceReader
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry
    from raht3dgs_tpu_torch.models.temporal import _unpack_motion

    if isinstance(streams, (str, os.PathLike)):
        streams = SequenceReader(streams)
    vms = _f32(viewmats, dev)
    Kms = _f32(Ks, dev)
    bg = _f32(np.ones(3) if bg is None else bg, dev)

    prev = None  # (codes, attrs, weights) of the previous frame, on the device
    for i, stream in enumerate(streams):
        # the frame's span closes before the yield: the consumer's own spans
        # are not the frame's children
        with timing.span("serve"):
            if not isinstance(stream, FrameStream):
                stream = FrameStream.from_bytes(stream)
            if stream.inter and prev is None:
                raise ValueError(f"frame {i} is inter but no frame precedes")
            if stream.inter and stream.motion is None:
                raise NotImplementedError(
                    "serve_sequence: v2 derived-motion stream — decode "
                    "normatively with SequenceCodec.decode_sequence")
            with timing.span("geometry"):
                if positions is None:
                    if stream.geometry is None:
                        raise ValueError(
                            f"frame {i} carries no geometry section; pass positions")
                    Vt = positions_from_geometry(stream.geometry, stream.depth,
                                                 stream.n_voxels, device=dev)
                else:
                    Vt = positions(i) if callable(positions) else positions[i]
                Vt = np.asarray(Vt, dtype=np.int64)
                if len(Vt) != stream.n_voxels:
                    raise ValueError(
                        f"frame {i}: {len(Vt)} positions != {stream.n_voxels} coded voxels")
                depth = stream.depth
                P = -((-max(len(Vt), 1)) // bucket) * bucket
                codes_p, w_p = _padded_frame_np(Vt, depth, P)
            vals_T = np.zeros((stream.n_channels, P), dtype=np.int32)
            k = stream.n_voxels
            if progressive:
                if stream.inter:
                    raise ValueError(
                        "progressive serving needs an all-intra sequence — "
                        "a truncated residual corrupts the prediction chain")
                k = int(min(max(progressive, 1), stream.n_voxels))
            decode_entropy_channels(stream, k, vals_T)
            mv = (None if not stream.inter else torch.as_tensor(
                _unpack_motion(stream.motion, codes_p, stream.n_voxels, P, depth), device=dev))
            with timing.span("upload"):
                vals_dev = upload_quantized(pack_quantized_upload(vals_T), device=dev)
                codes_dev = to_device(codes_p, dev)
                weights_dev = to_device(w_p, dev)
            pc, pa, pw = prev if stream.inter else (None, None, None)
            imgs, dups, tiles, attrs = _seq_step_body(
                vals_dev, codes_dev, weights_dev, stream.n_voxels,
                _steps_f32(stream.steps, dev), mv, pc, pa, pw,
                stream.predict_mask if stream.predict else None,
                float(stream.width) / (1 << depth), np.asarray(stream.vmin), vms, Kms, bg,
                depth=depth, probes=stream.probes, order_mode=stream.order_mode,
                quant_mode=stream.quant_mode, rec_delta=stream.rec_delta, width=width,
                height=height, devices=devices, **raster)
            prev = (codes_dev, attrs, weights_dev)
        yield imgs, dups, tiles
