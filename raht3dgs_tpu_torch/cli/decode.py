"""Standalone decoder: .r3tc frame stream or .r3ts sequence (+ voxel
positions) -> PLY.

Counterpart of ``raht3dgs_tpu/cli/decode.py``. With ``--positions`` (any
PLY with x/y/z; with ``--color-space 3dgs`` the compressed-3DGS PLY with
its voxel metadata) it rebuilds the transform structure from the
positions, decodes on CUDA unless ``--platform cpu``, and writes the
reconstruction in the positions file's point order, as an ASCII PLY or,
for a 56-channel 3DGS stream, as a renderable 3DGS PLY. Streams written
with ``--code-geometry`` carry their own lossless geometry: they decode
without ``--positions`` (rows in Morton order; for ``--color-space 3dgs``
the world mapping comes from the header's ``width`` and ``vmin``), a given
positions file is checked against that geometry, and ``--geometry-lod L``
writes the coarse level-L positions alone. ``--lod L`` decodes the stream
prefix of the level-L cells and writes one point a cell.

An ``.r3ts`` sequence decodes one frame (``--frame-index``; a predicted
frame replays the chain from the nearest clean entry point, which needs
``--code-geometry`` streams) or every frame (``--all-frames``, with a
``{i}`` placeholder in ``--output`` and ``--positions``), inter frames
through ``models/temporal.py`` in the dtype the stream records.

    python -m raht3dgs_tpu_torch.cli.decode --stream frame.r3tc \\
        --positions frame.ply --output recon.ply [--color-space yuv|raw|3dgs]
    python -m raht3dgs_tpu_torch.cli.decode --stream seq.r3ts --all-frames \\
        --output 'rec_{i}.ply'

Not ported yet, each exiting with its ROADMAP queue A item: R3TT tiles,
alone or inside a sequence, and ``--roi`` (item 15).
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
    p.add_argument("--stream", required=True,
                   help=".r3tc frame bitstream or .r3ts sequence file")
    p.add_argument(
        "--frame-index", type=int, default=0,
        help="frame to decode when --stream is an .r3ts sequence. Predicted "
        "(P) frames replay the chain from the nearest preceding I-frame "
        "(needs --code-geometry streams); --gop bounds the replay at encode time",
    )
    p.add_argument(
        "--all-frames", action="store_true",
        help="decode every frame of an .r3ts sequence; --output (and "
        "--positions when given) must contain a '{i}' placeholder (0-based)",
    )
    p.add_argument("--positions", default=None,
                   help="PLY carrying the voxel positions (x/y/z; other "
                   "properties ignored). Optional when the stream carries a "
                   "lossless geometry section (the encoders' --code-geometry)")
    p.add_argument("--output", required=True, help="reconstructed PLY path")
    p.add_argument(
        "--progressive", type=int, default=0, metavar="K",
        help="decode only the first K entropy symbols per channel — a "
        "coarse-to-fine preview. 0 = full decode. Intra frames only",
    )
    p.add_argument(
        "--lod", type=int, default=0, metavar="L",
        help="level-of-detail decode: the frame at octree depth L (one point "
        "per occupied level-L cell, attributes = the cell means for unit "
        "weights) from just the matching stream prefix. Needs the RA-GFT "
        "order (the default). Intra frames only",
    )
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
    if args.roi is not None:
        raise not_ported("--roi", 15, "the tiled .r3tt stream")
    if args.progressive < 0:
        raise SystemExit(f"--progressive must be positive (got {args.progressive})")
    device = resolve_device(args.platform)
    with maybe_profile(args, device):
        return _run(args, device)


def _run(args, device) -> int:
    from raht3dgs_tpu_torch.codec.bitstream import FrameStream, SequenceReader

    with open(args.stream, "rb") as f:
        magic = f.read(4)
    if magic == b"R3TT":
        raise not_ported("a R3TT input", 15, "the tiled container")
    if magic != b"R3TS":
        with open(args.stream, "rb") as f:
            _decode_one(args, FrameStream.from_bytes(f.read()), args.positions,
                        args.output, device)
        return 0
    seq = SequenceReader(args.stream)
    if len(seq) and seq.frame_bytes(0)[:4] == b"R3TT":
        raise not_ported("a sequence of R3TT frames", 15, "the tiled container")
    if args.all_frames:
        return _all_frames(args, seq, device)
    print(f"sequence of {len(seq)} frames; decoding frame {args.frame_index}")
    stream = seq.frame(args.frame_index)
    seq_codec, geom_prev = _replay_to(seq, args, stream, device)
    _decode_one(args, stream, args.positions, args.output, device,
                seq_codec=seq_codec, geom_prev=geom_prev)
    return 0


def _sequence_codec(stream, device):
    """A sequence codec replaying the encoder's transform dtype (recorded in
    the stream), not the CLI's flag: the closed loop needs the same bits."""
    import torch

    from raht3dgs_tpu_torch.models.temporal import SequenceCodec

    return SequenceCodec(stream.depth, device=device,
                         dtype=torch.float32 if stream.dtype32 else torch.float64)


def _all_frames(args, seq, device) -> int:
    """Every frame of a sequence in order. Predictions chain only across
    consecutive same-depth frames (one codec a depth, reset on a depth
    change): the encoder (``encode_dataset --inter``) keeps the same rule."""
    if "{i}" not in args.output or (args.positions is not None
                                    and "{i}" not in args.positions):
        raise SystemExit("--all-frames needs a '{i}' placeholder in --output "
                         "(and in --positions when given)")
    streams = [seq.frame(i) for i in range(len(seq))]
    codecs = {}
    if any(s.inter for s in streams):
        for s in streams:
            codecs.setdefault(s.depth, _sequence_codec(s, device))
    prev_depth = None
    geom_prev = (None, None)  # (codes, depth) of frame i-1
    for i, stream in enumerate(streams):
        sc = codecs.get(stream.depth)
        if sc is not None and prev_depth != stream.depth:
            sc.reset()
        codes = _decode_one(
            args, stream, None if args.positions is None else args.positions.format(i=i),
            args.output.format(i=i), device, seq_codec=sc,
            geom_prev=geom_prev[0] if geom_prev[1] == stream.depth else None)
        geom_prev = (codes, stream.depth)
        prev_depth = stream.depth
    print(f"decoded all {len(seq)} frames of {args.stream}")
    return 0


def _replay_to(seq, args, stream, device):
    """Random access to one frame of a sequence. A predicted frame (inter
    attributes or temporal geometry) walks back to the nearest clean entry
    point (intra attributes and intra geometry: encoders keep I-frames
    geometry-intra so these exist) and replays the chain up to the target.
    Returns (sequence codec, previous geometry codes) for the target's
    decode, (None, None) when the target is itself an entry point."""
    from raht3dgs_tpu_torch.codec.geometry import _positions, decode_geometry
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame

    i = args.frame_index

    def _clean(s):
        return not s.inter and (s.geometry is None or s.geometry[0] in (0, 3))

    if i == 0 or _clean(stream):
        return None, None
    if args.progressive or args.lod or args.geometry_lod:
        raise SystemExit("--progressive/--lod/--geometry-lod apply to intra frames "
                         "only — this frame is predicted (pick an I-frame index)")
    chain = {i: stream}
    start = i
    while start > 0 and not _clean(chain[start]):
        start -= 1
        chain[start] = seq.frame(start)
    if not _clean(chain[start]):
        raise SystemExit("no clean random-access point precedes this frame (frame 0 "
                         "is predicted?) — decode with --all-frames")
    print(f"predicted frame: replaying the chain from frame {start}")
    sc = geom_prev = prev_depth = None
    for j in range(start, i):
        s = chain[j]
        if s.geometry is None:
            raise SystemExit(
                "random access to a predicted frame needs self-contained geometry "
                "in every chained frame (re-encode with --code-geometry) or "
                "--all-frames with --positions")
        if sc is None or s.depth != prev_depth:
            sc = _sequence_codec(s, device)
        codes = decode_geometry(s.geometry, s.depth, s.n_voxels,
                                prev_codes=geom_prev if prev_depth == s.depth else None)
        V = _positions(codes, s.depth, device)
        frame = prepare_voxel_frame(V, np.zeros((len(V), s.n_channels)), s.depth,
                                    bucket=args.bucket, dtype=sc.codec.dtype, device=device)
        sc.decode_frame(s, frame)  # advances the prediction chain
        geom_prev = codes
        prev_depth = s.depth
    if prev_depth != stream.depth:
        # predictions never chain across a depth change, so the target
        # would have to be clean: the stream is corrupt
        raise SystemExit("corrupt sequence: predicted frame follows a depth change")
    return sc, geom_prev


def _geometry_lod(args, stream, output_path, device) -> None:
    """``--geometry-lod L``: the coarse level-L cells of the stream's own
    geometry, scaled back onto the full-depth grid (cell centres), so
    previews at different L overlay."""
    from raht3dgs_tpu_torch.codec.geometry import positions_from_geometry_lod
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii

    if args.progressive or args.lod:
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
    save_ply_ascii(output_path, (V.astype(np.float64) + 0.5) * scale - 0.5,
                   width=(1 << stream.depth) - 1)
    print(f"geometry LOD {args.geometry_lod}/{stream.depth}: {len(V)} coarse cells "
          f"from {stream.n_voxels} voxels -> {output_path}")


def _decode_one(args, stream, positions_path, output_path, device, seq_codec=None,
                geom_prev=None):
    """Decode one frame: positions from ``positions_path`` (checked against
    an intra geometry section when the stream has one) or from the stream's
    own geometry (a temporal section predicted from ``geom_prev``), then the
    attributes. Returns the frame's codes when they came from the stream
    (the next frame's geometry reference), else None."""
    from raht3dgs_tpu_torch.codec.geometry import (
        _positions,
        codes_from_positions,
        decode_geometry,
    )
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply, read_ply

    if args.geometry_lod:
        _geometry_lod(args, stream, output_path, device)
        return None
    gs = args.color_space == "3dgs"
    if gs and stream.n_channels < 8:
        raise SystemExit(f"--color-space 3dgs needs the 56-channel layout, stream "
                         f"has {stream.n_channels}")
    if positions_path is None:
        if stream.geometry is None:
            raise SystemExit("stream carries no geometry section; pass --positions "
                             "(or re-encode with --code-geometry)")
        try:
            codes = decode_geometry(stream.geometry, stream.depth, stream.n_voxels,
                                    prev_codes=geom_prev)
        except ValueError as e:
            if "needs prev_codes" in str(e):
                raise SystemExit(
                    "temporal geometry stream: decode the whole sequence with "
                    "--all-frames so the geometry chain can replay from frame 0")
            raise
        V_int = _positions(codes, stream.depth, device)
        # encode_3dgs stores width = voxel_size * 2**J and the true vmin
        gs_meta = (stream.width / (1 << stream.depth), stream.vmin) if gs else None
        _decode_attrs(args, stream, V_int.astype(np.float64), gs_meta, output_path, device,
                      seq_codec, morton_ordered=True)
        return codes
    gs_meta = None
    if gs:
        try:
            # the integer voxel coordinates are the x/y/z columns
            V_int, _, voxel_size, vmin = read_compressed_3dgs_ply(positions_path)
        except (ValueError, KeyError) as e:
            raise SystemExit(
                f"--color-space 3dgs: {positions_path} is not a compressed-3DGS PLY "
                f"(needs rot_*/scale_*/opacity/f_dc_* properties): {e}")
        V = V_int.astype(np.float64)
        gs_meta = (voxel_size, vmin)
    else:
        v = read_ply(positions_path).vertices
        V = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if len(V) != stream.n_voxels:
        raise SystemExit(
            f"stream encodes {stream.n_voxels} voxels but {positions_path} "
            f"has {len(V)} points"
        )
    if stream.geometry is not None and stream.geometry[0] in (0, 3):
        # a wrong positions file with the right point count would otherwise
        # decode the attributes onto the wrong voxels silently
        own = decode_geometry(stream.geometry, stream.depth, stream.n_voxels)
        if not np.array_equal(codes_from_positions(V, stream.depth).astype(np.int64),
                              own.astype(np.int64)):
            raise SystemExit(
                f"{positions_path} does not match the geometry coded in the stream "
                "(same count, different voxels) — wrong positions file?")
    _decode_attrs(args, stream, V, gs_meta, output_path, device, seq_codec)
    return None


def _save_3dgs(path, means, attrs, voxel_size, vmin) -> None:
    """The compressed-3DGS convention: x/y/z hold the integer voxel
    coordinates, the header the world mapping; quaternions renormalized
    (identity below 1e-8), |scales|, opacity clipped to [0, 1]."""
    from raht3dgs_tpu_torch.io.ply import save_ply_3dgs

    quats = attrs[:, 0:4]
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = np.where(norm > 1e-8, quats / np.maximum(norm, 1e-8),
                     np.array([[1.0, 0, 0, 0]]))
    save_ply_3dgs(path, means=means, quats=quats, scales=np.abs(attrs[:, 4:7]),
                  opacities=np.clip(attrs[:, 7], 0.0, 1.0), colors=attrs[:, 8:],
                  voxel_size=float(voxel_size), vmin=vmin)


def _save_colour(args, stream, path, V, attrs, device) -> bool:
    """An ASCII PLY with RGB for a 3-channel YUV stream (True), else the
    positions alone (False: the caller writes the attributes beside it)."""
    import torch

    from raht3dgs_tpu_torch.io.ply import save_ply_ascii
    from raht3dgs_tpu_torch.ops.color import yuv_to_rgb

    if args.color_space == "yuv" and stream.n_channels == 3:
        rgb = yuv_to_rgb(torch.as_tensor(attrs, device=device)).cpu().numpy()
        save_ply_ascii(path, V, np.clip(rgb, 0, 255).astype(int))
        return True
    save_ply_ascii(path, V, None)
    return False


def _decode_lod(args, stream, frame, gs_meta, output_path, dtype, device) -> None:
    """``--lod L``: one point a level-L cell from the stream prefix above the
    cut, written like a full decode (the 3DGS voxel size scaled to the
    cell), with the cell weights beside it."""
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    if args.progressive:
        raise SystemExit("--progressive and --lod are mutually exclusive (an LOD "
                         "decode IS a specific progressive prefix)")
    codec = AttributeCodec(stream.depth, dtype=dtype, order_mode=stream.order_mode,
                           device=device)
    try:
        pos, rec, cell_w = codec.decode_lod(stream, frame.codes, frame.weights, args.lod)
    except ValueError as e:  # a bad level, a non-RA-GFT order
        raise SystemExit(str(e))
    print(f"LOD {args.lod}/{stream.depth}: {len(pos)} cells from {stream.n_voxels} "
          f"voxels ({len(pos)} of {stream.n_voxels} coefficients decoded)")
    if gs_meta is not None:
        voxel_size, vmin = gs_meta
        _save_3dgs(output_path, pos.astype(np.float64), rec,
                   float(voxel_size) * float(2 ** (stream.depth - args.lod)), vmin)
    elif not _save_colour(args, stream, output_path, pos.astype(float), rec, device):
        np.save(output_path + ".attrs.npy", rec)
    np.save(output_path + ".cellw.npy", cell_w)


def _decode_attrs(args, stream, V, gs_meta, output_path, device, seq_codec=None,
                  morton_ordered=False) -> None:
    from raht3dgs_tpu_torch.models.pipeline import (
        AttributeCodec,
        prepare_voxel_frame,
        progressive_prefix_bytes,
    )
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    # a sequence replays the encoder's dtype, recorded in the stream
    dtype = seq_codec.codec.dtype if seq_codec is not None else torch_dtype(args.dtype)
    Vi = np.floor(V).astype(np.int64)
    frame = prepare_voxel_frame(Vi, np.zeros((len(V), stream.n_channels)),
                                stream.depth, bucket=args.bucket, dtype=dtype,
                                device=device)
    if stream.inter and seq_codec is None:
        raise SystemExit("inter (predicted) frame: decode the whole sequence with "
                         "--all-frames so the prediction can chain from frame 0")
    if seq_codec is not None:
        if args.progressive or args.lod:
            raise SystemExit("--progressive/--lod apply to standalone intra frames only "
                             "(sequence decode chains predictions through full frames)")
        rec = seq_codec.decode_frame(stream, frame)
    elif args.lod:
        _decode_lod(args, stream, frame, gs_meta, output_path, dtype, device)
        return
    else:
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
        _save_3dgs(output_path, V, out_attrs, *gs_meta)
    elif not _save_colour(args, stream, output_path, V, out_attrs, device):
        # attributes sidecar for payloads that are not colour
        np.save(output_path + ".attrs.npy", out_attrs)
        print(f"attributes written to {output_path}.attrs.npy")
    print(
        f"decoded {stream.n_voxels} voxels x {stream.n_channels} channels "
        f"(J={stream.depth}, steps={stream.steps.tolist()}, "
        f"order={stream.order_mode}) -> {output_path}"
    )


if __name__ == "__main__":
    sys.exit(main())
