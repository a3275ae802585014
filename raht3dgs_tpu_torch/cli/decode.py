"""Standalone decoder: .r3tc frame stream + voxel positions -> PLY.

Counterpart of ``raht3dgs_tpu/cli/decode.py`` for R3TC frame streams with
``--positions`` (any PLY with x/y/z): it rebuilds the transform structure
from the positions, decodes on CUDA unless ``--platform cpu``, and writes
the reconstruction in the positions file's point order.

    python -m raht3dgs_tpu_torch.cli.decode --stream frame.r3tc \\
        --positions frame.ply --output recon.ply [--color-space yuv]

Not ported yet, each exiting with its ROADMAP queue A item: R3TS sequences
and R3TT tiles, ``--frame-index``, ``--all-frames``, ``--lod`` and
``--roi`` (item 15); streams with a geometry section, decoding without
``--positions`` and ``--geometry-lod`` (item 12); ``--color-space 3dgs``
(item 11); inter frames (item 14).
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
                   "properties ignored)")
    p.add_argument("--output", required=True, help="reconstructed PLY path")
    p.add_argument(
        "--progressive", type=int, default=0, metavar="K",
        help="decode only the first K entropy symbols per channel — a "
        "coarse-to-fine preview. 0 = full decode",
    )
    p.add_argument("--lod", type=int, default=0, metavar="L",
                   help="level-of-detail decode (not ported yet: item 15)")
    p.add_argument("--geometry-lod", type=int, default=0, metavar="L",
                   help="positions-only preview from the geometry section "
                   "(not ported yet: item 12)")
    p.add_argument("--roi", type=int, nargs=6, default=None,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="region of a tiled stream (not ported yet: item 15)")
    p.add_argument(
        "--color-space", choices=("yuv", "raw", "3dgs"), default="yuv",
        help="'yuv': the stream holds BT.709 YUV (the encode_ply path), "
        "converted back to RGB; 'raw': attributes written as they are; "
        "'3dgs' is not ported yet (item 11)",
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
    if args.geometry_lod:
        raise not_ported("--geometry-lod", 12, "the geometry coder")
    if args.color_space == "3dgs":
        raise not_ported("--color-space 3dgs", 11, "the 3DGS codec")
    if args.positions is None:
        raise not_ported("decoding without --positions", 12, "the geometry coder")
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
    if stream.inter:
        raise not_ported("an inter frame", 14, "temporal prediction")
    if stream.geometry is not None:
        raise not_ported("a stream with a geometry section", 12,
                         "the geometry coder (the positions file cannot be checked)")
    _decode_attrs(args, stream, device)
    return 0


def _decode_attrs(args, stream, device) -> None:
    import torch

    from raht3dgs_tpu_torch.io.ply import read_ply, save_ply_ascii
    from raht3dgs_tpu_torch.models.pipeline import (
        AttributeCodec,
        prepare_voxel_frame,
        progressive_prefix_bytes,
    )
    from raht3dgs_tpu_torch.ops.color import yuv_to_rgb
    from raht3dgs_tpu_torch.utils.synth import morton_codes_np

    v = read_ply(args.positions).vertices
    V = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if len(V) != stream.n_voxels:
        raise SystemExit(
            f"stream encodes {stream.n_voxels} voxels but {args.positions} "
            f"has {len(V)} points"
        )
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

    # decoded rows are Morton-sorted; map them back to the input point order
    order = np.argsort(morton_codes_np(Vi, stream.depth), kind="stable")
    out_attrs = np.empty_like(rec)
    out_attrs[order] = rec

    if args.color_space == "yuv" and stream.n_channels == 3:
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
