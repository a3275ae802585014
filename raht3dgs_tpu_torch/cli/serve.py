"""Serve a compressed 3DGS stream straight to rendered views.

Counterpart of ``raht3dgs_tpu/cli/serve.py``, over ``models/serving.py``:
the compressed container goes in, PNG views come out, and the decoded
attributes stay on the device (CUDA unless ``--platform cpu``); per frame
the host touches only entropy symbols and the signalled motion field of
inter frames. The PNGs are written by ``io/png.py`` (no imaging package).

Containers, told apart by their magic:

- ``.r3tc`` single frame (plain or predicted-RAHT): served as a one-frame
  sequence;
- ``.r3ts`` temporal sequence: playback with the reconstruction kept on
  the device across I/P frames (``serve_sequence``); a sequence of tiled
  frames (``encode_dataset --tiles``) serves each frame as below;
- ``.r3tt`` tiled frame: only the bricks the cameras can see are decoded
  (``serve_tiled_frame``), or those meeting ``--roi``.

Cameras default to a random orbit around the scene bounds (focal ``1.2 *
width``, looking at the scene centre). One JSON summary line ends the run.

    python -m raht3dgs_tpu_torch.cli.serve --stream frame.r3tc --out views/
    python -m raht3dgs_tpu_torch.cli.serve --stream seq.r3ts --out views/ \\
        --views 8 --size 512 --u8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from raht3dgs_tpu_torch.cli._common import add_runtime_args
from raht3dgs_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stream", required=True,
                   help=".r3tc frame, .r3ts sequence, or .r3tt tiled frame")
    p.add_argument("--out", required=True, help="output directory for PNG views")
    p.add_argument(
        "--positions", default=None,
        help="PLY carrying voxel positions when the stream has no geometry "
        "section; use a '{i}' placeholder for sequences")
    p.add_argument("--views", type=int, default=4, help="views rendered per frame")
    p.add_argument("--size", type=int, default=512, help="square image size in pixels")
    p.add_argument("--seed", type=int, default=0, help="camera orbit seed")
    p.add_argument("--radius-scale", type=float, default=1.4,
                   help="camera orbit radius as a multiple of the scene half-width")
    p.add_argument(
        "--progressive", type=int, default=0, metavar="K",
        help="preview serve from a stream PREFIX: decode only the first K "
        "entropy symbols per channel (coarse coefficients come first in both "
        "orders). On an inter sequence, serves the I-frames only (original "
        "frame numbers kept). 0 = full decode")
    p.add_argument(
        "--u8", action="store_true",
        help="quantize images to uint8 on the device (a quarter of the fetched "
        "bytes; the display convention — keep float for PSNR evaluation)")
    p.add_argument(
        "--margin", type=float, default=0.0,
        help="tiled serving: widen brick boxes by this many world units before "
        "the frustum cull (~3x the largest splat scale for exactly-matching "
        "renders; 0 culls on voxel extents)")
    p.add_argument(
        "--roi", type=int, nargs=6, default=None,
        metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
        help="tiled serving: serve only the bricks meeting this half-open voxel "
        "box instead of frustum-culling (decode --roi's selection, rendered)")
    p.add_argument("--max-per-tile", type=int, default=8192,
                   help="rasterizer per-tile capacity")
    p.add_argument("--sh-degree", type=int, default=3)
    add_runtime_args(p)
    return p


def _positions_for(args, i):
    if args.positions is None:
        return None
    from raht3dgs_tpu_torch.io.ply import read_ply_8i

    V, _, _ = read_ply_8i(args.positions.format(i=i))
    return np.floor(np.asarray(V)).astype(np.int64)


def _cameras(meta_vmin, width, args):
    from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras

    center = np.asarray(meta_vmin, dtype=np.float64) + width / 2.0
    vms, Kms, _, _ = generate_random_cameras(
        center, args.radius_scale * width / 2.0, n_views=args.views,
        image_width=args.size, image_height=args.size, seed=args.seed)
    return vms, Kms


def _write_views(out_dir, frame_idx, imgs, u8):
    from raht3dgs_tpu_torch.io.png import write_png

    arr = imgs.cpu().numpy()
    if not u8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    paths = []
    for v in range(arr.shape[0]):
        path = out_dir / f"frame_{frame_idx:04d}_view_{v:02d}.png"
        write_png(path, arr[v])
        paths.append(str(path))
    return paths


def _check_3dgs(n_channels) -> bool:
    if n_channels < 8:
        print(f"stream has {n_channels} channels; serving renders 3DGS scenes "
              "(quats/scales/opacity/SH >= 8 channels) — decode color streams with "
              "cli.decode instead", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    import pathlib

    import torch

    from raht3dgs_tpu_torch.codec.bitstream import (
        MAGIC,
        SEQ_MAGIC,
        FrameStream,
        SequenceReader,
    )
    from raht3dgs_tpu_torch.models.serving import serve_sequence, serve_tiled_frame
    from raht3dgs_tpu_torch.models.tiling import TILE_MAGIC, TiledReader

    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(args.stream, "rb") as f:
        magic = f.read(4)
    raster = dict(sh_degree=args.sh_degree, tile=16, max_tiles_per_gauss=16,
                  max_per_tile=args.max_per_tile, chunk=128,
                  image_dtype=torch.uint8 if args.u8 else torch.float32, device=device)
    t0 = time.perf_counter()

    def serve_tiled(reader, i, vms, Kms):
        bricks = reader.select_roi(args.roi[:3], args.roi[3:]) if args.roi else None
        imgs, _, _, sel = serve_tiled_frame(
            reader, vms, Kms, width=args.size, height=args.size,
            positions=_positions_for(args, i), margin=args.margin, bricks=bricks, **raster)
        return _write_views(out_dir, i, imgs, args.u8), len(sel)

    if magic == TILE_MAGIC:
        with open(args.stream, "rb") as f:
            reader = TiledReader(f.read())
        if len(reader) and not _check_3dgs(reader.tile(0).n_channels):
            return 2
        vms, Kms = _cameras(reader.meta.vmin, float(reader.meta.width), args)
        written, served = serve_tiled(reader, 0, vms, Kms)
        rec = {"frames": 1, "views": args.views, "container": "r3tt",
               "bricks_served": served, "bricks_total": len(reader)}
    elif magic in (MAGIC, SEQ_MAGIC):
        if magic == SEQ_MAGIC:
            seq = SequenceReader(args.stream)
            blobs = [seq.frame_bytes(i) for i in range(len(seq))]
        else:
            with open(args.stream, "rb") as f:
                blobs = [f.read()]
        if blobs and blobs[0][:4] == TILE_MAGIC:
            # a tiled sequence (encode_dataset --tiles): every frame frustum-culled
            written, served = [], 0
            vms = Kms = None
            for i, blob in enumerate(blobs):
                tr = TiledReader(blob)
                if vms is None:
                    if len(tr) and not _check_3dgs(tr.tile(0).n_channels):
                        return 2
                    vms, Kms = _cameras(tr.meta.vmin, float(tr.meta.width), args)
                paths, n = serve_tiled(tr, i, vms, Kms)
                written += paths
                served += n
            rec = {"frames": len(blobs), "views": args.views, "container": "r3ts[r3tt]",
                   "bricks_served": served}
        else:
            streams = [FrameStream.from_bytes(b) for b in blobs]
            s0 = streams[0]
            if not _check_3dgs(s0.n_channels):
                return 2
            vms, Kms = _cameras(np.asarray(s0.vmin), float(s0.width), args)
            # --progressive on an inter sequence: a preview from the I-frames
            # alone (each decodes on its own; a cut P residual would corrupt
            # the prediction chain), keeping the original frame numbers
            frame_ids = list(range(len(streams)))
            if args.progressive and any(s.inter for s in streams):
                frame_ids = [i for i, s in enumerate(streams) if not s.inter]
                print(f"progressive preview of an inter sequence: serving the "
                      f"{len(frame_ids)} I-frames of {len(streams)} (indices {frame_ids})",
                      file=sys.stderr)
                streams = [streams[i] for i in frame_ids]
            positions = (None if args.positions is None
                         else lambda i: _positions_for(args, frame_ids[i]))
            written = []
            n_frames = 0
            # pipelined consumer: frame k-1's images are fetched and written
            # after frame k is dispatched, so the host's entropy decode and
            # upload of frame k overlap frame k-1's render on the device
            prev = None
            for imgs, _, _ in serve_sequence(
                    streams, vms, Kms, width=args.size, height=args.size,
                    positions=positions, progressive=args.progressive, **raster):
                if prev is not None:
                    written += _write_views(out_dir, frame_ids[n_frames - 1], prev, args.u8)
                prev = imgs
                n_frames += 1
            if prev is not None:
                written += _write_views(out_dir, frame_ids[n_frames - 1], prev, args.u8)
            rec = {"frames": n_frames, "views": args.views,
                   "container": "r3ts" if magic == SEQ_MAGIC else "r3tc"}
    else:
        print(f"unrecognized stream magic {magic!r}", file=sys.stderr)
        return 2

    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    rec["images"] = len(written)
    rec["out"] = str(out_dir)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
