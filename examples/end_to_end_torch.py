#!/usr/bin/env python3
"""End-to-end walkthrough of the PyTorch port on synthetic data.

The port's counterpart of ``examples/end_to_end.py``: the same ten
sections, the same inputs (one numpy generator, seed 0) and the same
printed lines, through ``raht3dgs_tpu_torch``:

1. raw float point cloud -> voxelize (duplicate merge)
2. color frame -> RAHT -> quantize -> RLGR -> container bytes -> decode
3. 3DGS scene -> voxelize+merge -> 56-channel codec -> per-group PSNR
4. rate-targeted encoding
5. multi-frame batched encode
6. indexed sequence file + chunked (parallel-decodable) entropy streams;
   6b. predicted RAHT
7. render-PSNR evaluation via the port's volumetric rasterizer
8. serving: stream -> decode + multi-view render on the device
9. self-contained streams: lossless geometry sections (incl. temporal
   prediction between frames) — decode with no out-of-band positions
10. progressive (prefix) decode + level-of-detail decode; 10b. geometry LOD

Run: python examples/end_to_end_torch.py [--device cuda|cpu]  (CUDA by
default; without a card it raises unless given ``--device cpu``).

``compare_lines`` holds one run's lines against another's (this example's
on the CPU against the JAX example's, or the card's against the pinned CPU
lines in ``end_to_end_torch_cpu.txt``): integers, bpp, bytes, steps,
masks and cell counts equal as printed; PSNRs and RMSEs within
``PSNR_TOL`` of each other.
"""

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PINNED = Path(__file__).resolve().parent / "end_to_end_torch_cpu.txt"
# A printed PSNR or RMSE may differ by this much between two runs: they are
# printed to 0.01, and float32 renders and merges round differently on
# another device or package, which can move the last printed digit.
PSNR_TOL = 0.011
_NUM = re.compile(r"-?\d+(?:\.\d+)?")
# the numbers of a line that are PSNRs / RMSEs, by section tag and index
_TOLERANT = {"[2]": {1}, "[3]": {3, 4}, "[7]": {0}, "[10]": {2, 3}}


def compare_lines(got, want, tol: float = PSNR_TOL):
    """The differences between two runs' printed lines (empty when they
    agree): every line's words equal, every number equal as printed except
    the PSNRs / RMSEs of ``_TOLERANT``, which may differ by ``tol``."""
    got = [ln.rstrip() for ln in got if ln.strip()]
    want = [ln.rstrip() for ln in want if ln.strip()]
    diffs = []
    if len(got) != len(want):
        diffs.append(f"{len(got)} lines against {len(want)}")
    for g, w in zip(got, want):
        if _NUM.sub("#", g) != _NUM.sub("#", w):
            diffs.append(f"text differs:\n  {g}\n  {w}")
            continue
        tag, g_rest = (g.split(None, 1) + [""])[:2]
        loose = _TOLERANT.get(tag, set())
        gn, wn = _NUM.findall(g_rest), _NUM.findall(w.split(None, 1)[-1])
        for i, (a, b) in enumerate(zip(gn, wn)):
            if i in loose:
                if abs(float(a) - float(b)) > tol:
                    diffs.append(f"{tag} number {i}: {a} against {b} (tol {tol})")
            elif a != b:
                diffs.append(f"{tag} number {i}: {a} against {b}")
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from raht3dgs_tpu_torch.codec.bitstream import FrameStream
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
    from raht3dgs_tpu_torch.models.rd_search import search_step_for_bpp
    from raht3dgs_tpu_torch.ops.color import rgb_to_yuv
    from raht3dgs_tpu_torch.ops.voxelize import voxelize
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    depth = 8

    # ---- 1. voxelize a raw cloud -------------------------------------
    n = 60_000
    pts = rng.normal(size=(n, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)  # unit shell
    rgb = ((pts * 0.5 + 0.5) * 255).astype(np.float64)
    cloud = torch.as_tensor(np.concatenate([pts, rgb], axis=1), device=dev)
    vox = voxelize(cloud, depth)
    nvox = int(vox.nvox)
    print(f"[1] voxelized {n} points -> {nvox} voxels (J={depth})")

    # ---- 2. color codec roundtrip ------------------------------------
    V = vox.positions[:nvox].cpu().numpy()
    yuv = rgb_to_yuv(vox.attributes[:nvox]).cpu().numpy()
    frame = prepare_voxel_frame(V, yuv, depth, device=dev)
    codec = AttributeCodec(depth, device=dev)
    enc = codec.encode(frame, steps=4.0)
    blob = enc.stream.to_bytes()
    rec, _ = codec.decode(FrameStream.from_bytes(blob), frame.codes, frame.weights)
    ref = frame.attributes[: frame.n_voxels].cpu().numpy()
    mse = np.mean((rec[:, 0] - ref[:, 0]) ** 2)
    print(
        f"[2] color codec: {enc.stream.bpp():.3f} bpp, "
        f"Y-PSNR {10 * np.log10(255**2 / mse):.2f} dB, "
        f"container {len(blob)} bytes"
    )

    # ---- 3. 3DGS scene ------------------------------------------------
    m = 40_000
    scene = {
        "means": rng.normal(size=(m, 3)) * 0.3,
        "quats": rng.normal(size=(m, 4)),
        "scales": np.abs(rng.normal(size=(m, 3))) * 0.01,
        "opacities": rng.uniform(0.3, 1.0, size=m),
        "colors": rng.normal(size=(m, 48)) * 0.2,
    }
    scene["quats"] /= np.linalg.norm(scene["quats"], axis=1, keepdims=True)
    gs = compress_to_nvox(scene, depth=7, device=dev)
    r = slice(0, gs.n_voxels)
    attrs56 = np.concatenate(
        [gs.quats[r], gs.scales[r], gs.opacities[r][:, None], gs.colors[r]], axis=1
    )
    pts3dgs = encode_gs_frame(gs.positions_int[r], attrs56, depth=7, steps=(0.01,),
                              device=dev)
    p = pts3dgs[0]
    print(
        f"[3] 3DGS: {m} gaussians -> {gs.n_voxels} voxels; "
        f"{p.bpp:.2f} bpp @ PSNR_all {p.psnr['psnr_all']:.2f} dB "
        f"(quats {p.psnr['psnr_quats']:.2f})"
    )

    # ---- 4. rate-targeted encode --------------------------------------
    res = search_step_for_bpp(frame, target_bpp=2.0, codec=codec)
    print(
        f"[4] rate search: target 2.0 bpp -> step {res.step:.3f}, "
        f"actual {res.bpp:.3f} bpp ({res.probes} device probes)"
    )

    # ---- 5. batched frames --------------------------------------------
    from raht3dgs_tpu_torch.models.batch_codec import (
        BatchAttributeCodec,
        prepare_frame_batch,
    )

    positions, attributes = [], []
    for s in range(4):
        sub = rng.choice(nvox, size=nvox // 2, replace=False)
        positions.append(V[np.sort(sub)])
        attributes.append(yuv[np.sort(sub)])
    frames = prepare_frame_batch(positions, attributes, depth, device=dev)
    bc = BatchAttributeCodec(depth, device=dev)
    streams, _ = bc.encode(frames, steps=4.0)
    recs, _ = bc.decode(streams, frames)
    print(
        f"[5] batched: {len(frames)} frames in one dispatch, "
        f"rates {[round(s.bpp(), 2) for s in streams]} bpp"
    )
    # ---- 6. sequence container + chunked entropy ----------------------
    import tempfile

    from raht3dgs_tpu_torch.codec.bitstream import SequenceReader, write_sequence

    with tempfile.TemporaryDirectory() as td:
        seq_path = Path(td) / "frames.r3ts"
        write_sequence(seq_path, streams)
        seq = SequenceReader(seq_path)
        fr2 = seq.frame(2)  # O(1) random access
        print(
            f"[6] sequence: {len(seq)} frames in {seq_path.stat().st_size} "
            f"bytes; frame 2 has {fr2.n_voxels} voxels"
        )
    chunked = AttributeCodec(depth, chunk=4096, device=dev).encode(frame, steps=4.0)
    print(
        f"    chunked entropy: {chunked.stream.bpp():.3f} bpp "
        f"(vs {enc.stream.bpp():.3f} sequential; chunks decode in parallel)"
    )

    # ---- 6b. predicted RAHT: residuals against the coarser depth ------
    # Each depth group codes residuals against an upsampled prediction
    # from the coarser depth's reconstruction (docs/rd_predict.md); the
    # same stream layout, and the decoder replays the closed loop.
    pcodec = AttributeCodec(depth, predict=True, device=dev)
    penc = pcodec.encode(frame, steps=4.0)
    prec, _ = pcodec.decode(penc.stream, frame.codes, frame.weights)
    assert penc.stream.predict
    print(
        f"[6b] predicted RAHT: {penc.stream.bpp():.3f} bpp vs "
        f"{enc.stream.bpp():.3f} plain at the same step (mask "
        f"{penc.stream.predict_mask:0{depth}b}; decoder re-runs the "
        "identical closed loop)"
    )

    # ---- 7. render-PSNR via the port's volumetric rasterizer ----------
    from raht3dgs_tpu_torch.eval.render import render_comparison

    voxel_scene = {
        "means": (gs.positions_int[r] + 0.5) * float(gs.voxel_size)
        + np.asarray(gs.vmin),
        "quats": gs.quats[r],
        "scales": gs.scales[r],
        "opacities": gs.opacities[r],
        "colors": gs.colors[r],
    }
    metrics = render_comparison(
        scene, voxel_scene, n_views=2, image_size=128, backend="jax", device=dev
    )
    print(
        f"[7] render PSNR (volumetric, {metrics['backend']}): "
        f"{metrics['psnr_avg']:.2f} dB over {len(metrics['psnr_per_view'])} views"
    )

    # ---- 8. serving: stream -> decode + render on the device ----------
    from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels
    from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras
    from raht3dgs_tpu_torch.models.serving import (
        build_inverse_order,
        quantized_upload_array,
        serve_frame,
    )

    gs_frame = prepare_voxel_frame(
        gs.positions_int[r].astype(np.int64),
        np.concatenate(
            [gs.quats[r], gs.scales[r], gs.opacities[r][:, None],
             gs.colors[r]], axis=1,
        ).astype(np.float32),
        7, bucket=int(gs.n_voxels), dtype=torch.float32, device=dev,
    )
    gs_codec = AttributeCodec(7, dtype=torch.float32, device=dev)
    senc = gs_codec.encode(gs_frame, 0.005)
    vals = np.zeros((senc.stream.n_channels, gs_frame.codes.shape[0]),
                    dtype=np.int32)
    rlgr_decode_channels(senc.stream.channels, senc.stream.n_voxels,
                         out=vals, chunk=senc.stream.chunk)
    vals = quantized_upload_array(vals)  # int16 when representable
    inv = build_inverse_order(gs_frame.codes, gs_frame.weights,
                              senc.stream.n_voxels, 7, senc.stream.order_mode)
    vms, Kms, _, _ = generate_random_cameras(
        np.zeros(3), 3.0, n_views=2, image_width=128, image_height=128,
        seed=2,
    )
    imgs, dups, tiles = serve_frame(
        torch.as_tensor(vals, device=dev), inv, 0.005, gs_frame.codes,
        gs_frame.weights, float(gs.voxel_size), np.asarray(gs.vmin, np.float32),
        vms, Kms, np.ones(3, np.float32), depth=7, width=128, height=128,
        max_per_tile=16384, device=dev,
    )
    print(
        f"[8] fused serving: {senc.stream.n_voxels} voxels decoded + "
        f"{imgs.shape[0]} views rendered in one dispatch "
        f"(upload dtype {np.asarray(vals).dtype}, overflow "
        f"{int(dups.sum()) + int(tiles.sum())})"
    )

    # --- 9. self-contained streams: lossless geometry sections ----------
    from raht3dgs_tpu_torch.codec.geometry import (
        decode_geometry,
        encode_geometry,
        positions_from_geometry,
    )

    codes0 = gs_frame.codes[: gs_frame.n_voxels].cpu().numpy()
    sec = encode_geometry(codes0, 7)
    senc.stream.geometry = sec                    # container v4 section
    blob = senc.stream.to_bytes()
    back = FrameStream.from_bytes(blob)
    V_rec = positions_from_geometry(back.geometry, back.depth,
                                    back.n_voxels, device=dev)
    assert V_rec.shape == (back.n_voxels, 3)
    # temporal profile: a deformed "next frame" predicted from this one
    from raht3dgs_tpu_torch.ops.morton import morton_decode, morton_encode

    Vn = np.clip(
        morton_decode(torch.as_tensor(codes0.astype(np.int64), device=dev), 7)
        .cpu().numpy() + np.array([1, 0, 0]), 0, 127)
    codes1 = np.unique(morton_encode(torch.as_tensor(Vn, device=dev), 7).cpu().numpy())
    sec_p = encode_geometry(codes1, 7, prev_codes=codes0,
                            motion=(1, 0, 0))
    codes1_dec = decode_geometry(sec_p, 7, codes1.size, dtype=codes1.dtype,
                                 prev_codes=codes0)
    assert np.array_equal(codes1_dec, codes1)
    print(
        f"[9] self-contained stream: +{len(sec) * 8 / back.n_voxels:.2f} "
        f"bits/voxel lossless geometry (raw would be 21); temporal "
        f"P-frame section {len(sec_p) * 8 / codes1.size:.2f} b/v "
        f"(motion-compensated prediction from the previous frame)"
    )

    # --- 10. progressive + LOD decode -----------------------------------
    from raht3dgs_tpu_torch.models.pipeline import progressive_prefix_bytes

    k = max(frame.n_voxels // 10, 1)
    preview, _ = codec.decode_progressive(
        enc.stream, frame.codes, frame.weights, k
    )
    pos_lod, rec_lod, cell_w = codec.decode_lod(
        enc.stream, frame.codes, frame.weights, depth - 3
    )
    full_rmse = float(np.sqrt(np.mean((rec - ref) ** 2)))
    prev_rmse = float(np.sqrt(np.mean((preview - ref) ** 2)))
    print(
        f"[10] progressive: first {k}/{frame.n_voxels} coefficients -> "
        f"RMSE {prev_rmse:.2f} (full: {full_rmse:.2f}); LOD {depth - 3}: "
        f"{len(pos_lod)} cells with exact cell-mean attributes "
        f"(prefix {progressive_prefix_bytes(enc.stream, len(pos_lod))} "
        f"of {sum(len(s) for s in enc.stream.channels)} entropy bytes)"
    )

    # the geometry counterpart: coarse POSITIONS from a prefix-level walk
    # of the section coded in [9] — the deep octree levels are never
    # entropy-decoded (CLI: decode --geometry-lod L)
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry_lod

    V_coarse = positions_from_geometry_lod(sec, 7, codes0.size, 4, device=dev)
    print(
        f"[10b] geometry LOD 4/7: {len(V_coarse)} coarse cells from "
        f"{codes0.size} voxels without full geometry decode"
    )
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
