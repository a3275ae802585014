"""Standalone decoder: .r3tc frame stream (+ voxel positions) -> PLY.

Counterpart of ``raht3dgs_tpu/cli/decode.py`` for R3TC frame streams. With
``--positions`` (any PLY with x/y/z; with ``--color-space 3dgs`` the
compressed-3DGS PLY with its voxel metadata) it rebuilds the transform
structure from the positions, decodes on CUDA unless ``--platform cpu``,
and writes the reconstruction in the positions file's point order, as an
ASCII PLY or, for a 56-channel 3DGS stream, as a renderable 3DGS PLY.
Streams written with ``--code-geometry`` carry their own lossless
geometry: they decode without ``--positions`` (rows in Morton order; for
``--color-space 3dgs`` the world mapping comes from the header's
``width`` and ``vmin``), a given positions file is checked against that
geometry, and ``--geometry-lod L`` writes the coarse level-L positions
alone.

    python -m raht3dgs_tpu_torch.cli.decode --stream frame.r3tc \\
        --positions frame.ply --output recon.ply [--color-space yuv|raw|3dgs]
    python -m raht3dgs_tpu_torch.cli.decode --stream frame.r3tc --output recon.ply

Not ported yet, each exiting with its ROADMAP queue A item: R3TS sequences
and R3TT tiles, ``--frame-index``, ``--all-frames``, ``--lod`` and
``--roi`` (item 15); inter frames (item 14) and temporal geometry
sections, which decode only along their sequence (items 14 and 15).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from raht3dgs_tpu_torch.cli._common import (
    add_runtime_args,
    maybe_profile,
    not_ported,
    torch_dtype,
)
from raht3dgs_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stream", required=True, help=".r3tc frame bitstream")
    p.add_argument("--frame-index", type=int, default=0,
                   help="frame of an .r3ts sequence (not ported yet: item 15)")
    p.add_argument("--all-frames", action="store_true",
                   help="decode every frame of an .r3ts sequence (not ported "
                   "yet: item 15)")
    p.add_argument("--positions", default=None,
                   help="PLY carrying the voxel positions (x/y/z; other "
                   "properties ignored). Optional when the stream carries a "
                   "lossless geometry section (the encoders' --code-geometry)")
    p.add_argument("--output", required=True, help="reconstructed PLY path")
    p.add_argument(
        "--progressive", type=int, default=0, metavar="K",
        help="decode only the first K entropy symbols per channel — a "
        "coarse-to-fine preview. 0 = full decode",
    )
    p.add_argument("--lod", type=int, default=0, metavar="L",
                   help="level-of-detail decode (not ported yet: item 15)")
    p.add_argument("--geometry-lod", type=int, default=0, metavar="L",
                   help="positions-only preview: decode the stream's geometry "
                   "section down to octree depth L only and write the coarse "
                   "2^L-grid positions as a PLY, skipping the attributes. Needs "
                   "--code-geometry streams; intra geometry sections only")
    p.add_argument("--roi", type=int, nargs=6, default=None,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="region of a tiled stream (not ported yet: item 15)")
    p.add_argument(
        "--color-space", choices=("yuv", "raw", "3dgs"), default="yuv",
        help="'yuv': the stream holds BT.709 YUV (the encode_ply path), "
        "converted back to RGB; 'raw': attributes written as they are; "
        "'3dgs': a 56-channel stream written as a renderable 3DGS PLY "
        "(--positions must be the compressed-3DGS PLY with voxel metadata)",
    )
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.frame_index or args.all_frames:
        raise not_ported("--frame-index/--all-frames", 15, "the R3TS sequence container")
    if args.lod:
        raise not_ported("--lod", 15, "level-of-detail decode")
    if args.roi is not None:
        raise not_ported("--roi", 15, "the tiled .r3tt stream")
    if args.progressive < 0:
        raise SystemExit(f"--progressive must be positive (got {args.progressive})")
    device = resolve_device(args.platform)
    with maybe_profile(args, device):
        return _run(args, device)


def _run(args, device) -> int:
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream

    with open(args.stream, "rb") as f:
        data = f.read()
    if data[:4] in (b"R3TS", b"R3TT"):
        raise not_ported(f"a {data[:4].decode()} input", 15,
                         "the sequence and tiled containers")
    stream = FrameStream.from_bytes(data)
    if args.geometry_lod:
        _geometry_lod(args, stream, device)
    else:
        _decode_one(args, stream, device)
    return 0


def _geometry_lod(args, stream, device) -> None:
    """``--geometry-lod L``: the coarse level-L cells of the stream's own
    geometry, scaled back onto the full-depth grid (cell centres), so
    previews at different L overlay."""
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry_lod
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    if args.progressive:
        raise SystemExit("--geometry-lod is a positions-only preview — it cannot "
                         "combine with --progressive/--lod attribute decode")
    if stream.geometry is None:
        raise SystemExit("--geometry-lod needs a stream with a lossless geometry "
                         "section (re-encode with --code-geometry)")
    if stream.geometry[0] not in (0, 3):
        raise SystemExit("--geometry-lod applies to intra geometry sections only "
                         "(temporal sections chain full-depth codes from frame 0)")
    if not 1 <= args.geometry_lod <= stream.depth:
        raise SystemExit(f"--geometry-lod must be in 1..{stream.depth} (stream depth), "
                         f"got {args.geometry_lod}")
    V = positions_from_geometry_lod(stream.geometry, stream.depth, stream.n_voxels,
                                    args.geometry_lod, device=device)
    scale = float(2 ** (stream.depth - args.geometry_lod))
    save_ply_ascii(args.output, (V.astype(np.float64) + 0.5) * scale - 0.5,
                   width=(1 << stream.depth) - 1)
    print(f"geometry LOD {args.geometry_lod}/{stream.depth}: {len(V)} coarse cells "
          f"from {stream.n_voxels} voxels -> {args.output}")


def _decode_one(args, stream, device) -> None:
    """Positions from ``--positions`` (checked against an intra geometry
    section when the stream has one) or from the stream's own geometry,
    then the attribute decode."""
    from raht3dgs_tpu_torch.codec.geometry import (
        codes_from_positions,
        decode_geometry,
        positions_from_geometry,
    )
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply

    gs = args.color_space == "3dgs"
    if gs and stream.n_channels < 8:
        raise SystemExit(f"--color-space 3dgs needs the 56-channel layout, stream "
                         f"has {stream.n_channels}")
    if args.positions is None:
        if stream.geometry is None:
            raise SystemExit("stream carries no geometry section; pass --positions "
                             "(or re-encode with --code-geometry)")
        if stream.geometry[0] not in (0, 3):
            # a temporal section is predicted from the previous frame's
            raise SystemExit(
                "temporal geometry stream: decode the whole sequence with "
                "--all-frames so the geometry chain can replay from frame 0 "
                "(not ported yet: ROADMAP queue A, item 15)")
        V_int = positions_from_geometry(stream.geometry, stream.depth, stream.n_voxels,
                                        device=device)
        # encode_3dgs stores width = voxel_size * 2**J and the true vmin
        gs_meta = (stream.width / (1 << stream.depth), stream.vmin) if gs else None
        _decode_attrs(args, stream, V_int.astype(np.float64), gs_meta, device,
                      morton_ordered=True)
        return
    gs_meta = None
    if gs:
        try:
            # the integer voxel coordinates are the x/y/z columns
            V_int, _, voxel_size, vmin = read_compressed_3dgs_ply(args.positions)
        except (ValueError, KeyError) as e:
            raise SystemExit(
                f"--color-space 3dgs: {args.positions} is not a compressed-3DGS PLY "
                f"(needs rot_*/scale_*/opacity/f_dc_* properties): {e}")
        V = V_int.astype(np.float64)
        gs_meta = (voxel_size, vmin)
    else:
        v = read_ply(args.positions).vertices
        V = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if len(V) != stream.n_voxels:
        raise SystemExit(
            f"stream encodes {stream.n_voxels} voxels but {args.positions} "
            f"has {len(V)} points"
        )
    if stream.geometry is not None and stream.geometry[0] in (0, 3):
        # a wrong positions file with the right point count would otherwise
        # decode the attributes onto the wrong voxels silently
        own = decode_geometry(stream.geometry, stream.depth, stream.n_voxels)
        if not np.array_equal(codes_from_positions(V, stream.depth).astype(np.int64),
                              own.astype(np.int64)):
            raise SystemExit(
                f"{args.positions} does not match the geometry coded in the stream "
                "(same count, different voxels) — wrong positions file?")
    _decode_attrs(args, stream, V, gs_meta, device)


def _decode_attrs(args, stream, V, gs_meta, device, morton_ordered=False) -> None:
    import torch

    from raht3dgs_tpu_torch.io.ply import save_ply_3dgs, save_ply_ascii
    from raht3dgs_tpu_torch.models.pipeline import (
        AttributeCodec,
        prepare_voxel_frame,
        progressive_prefix_bytes,
    )
    from raht3dgs_tpu_torch.ops.color import yuv_to_rgb
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    if stream.inter:
        raise not_ported("an inter frame", 14, "temporal prediction")
    dtype = torch_dtype(args.dtype)
    Vi = np.floor(V).astype(np.int64)
    frame = prepare_voxel_frame(Vi, np.zeros((len(V), stream.n_channels)),
                                stream.depth, bucket=args.bucket, dtype=dtype,
                                device=device)
    codec = AttributeCodec(stream.depth, dtype=dtype, order_mode=stream.order_mode,
                           device=device)
    if args.progressive:
        rec, _ = codec.decode_progressive(stream, frame.codes, frame.weights,
                                          args.progressive)
        print(
            f"progressive preview: {min(args.progressive, stream.n_voxels)}"
            f"/{stream.n_voxels} coefficients, entropy prefix "
            f"{progressive_prefix_bytes(stream, args.progressive)} bytes "
            f"(full: {sum(len(s) for s in stream.channels)})"
        )
    else:
        rec, _ = codec.decode(stream, frame.codes, frame.weights)

    if morton_ordered:
        # positions from the geometry section are already in Morton order
        out_attrs = rec
    else:
        # decoded rows are Morton-sorted; map them back to the input point order
        order = np.argsort(morton_codes_np(Vi, stream.depth), kind="stable")
        out_attrs = np.empty_like(rec)
        out_attrs[order] = rec

    if gs_meta is not None:
        # the compressed-3DGS convention: x/y/z hold the integer voxel
        # coordinates, the header the world mapping; quaternions renormalized
        # (identity below 1e-8), |scales|, opacity clipped to [0, 1]
        voxel_size, vmin = gs_meta
        quats = out_attrs[:, 0:4]
        norm = np.linalg.norm(quats, axis=1, keepdims=True)
        quats = np.where(norm > 1e-8, quats / np.maximum(norm, 1e-8),
                         np.array([[1.0, 0, 0, 0]]))
        save_ply_3dgs(args.output, means=V, quats=quats,
                      scales=np.abs(out_attrs[:, 4:7]),
                      opacities=np.clip(out_attrs[:, 7], 0.0, 1.0),
                      colors=out_attrs[:, 8:], voxel_size=float(voxel_size), vmin=vmin)
    elif args.color_space == "yuv" and stream.n_channels == 3:
        rgb = yuv_to_rgb(torch.as_tensor(out_attrs, device=device)).cpu().numpy()
        save_ply_ascii(args.output, V, np.clip(rgb, 0, 255).astype(int))
    else:
        save_ply_ascii(args.output, V, None)
        # attributes sidecar for payloads that are not colour
        np.save(args.output + ".attrs.npy", out_attrs)
        print(f"attributes written to {args.output}.attrs.npy")
    print(
        f"decoded {stream.n_voxels} voxels x {stream.n_channels} channels "
        f"(J={stream.depth}, steps={stream.steps.tolist()}, "
        f"order={stream.order_mode}) -> {args.output}"
    )


if __name__ == "__main__":
    sys.exit(main())
