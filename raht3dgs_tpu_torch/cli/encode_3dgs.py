"""3DGS 56-channel codec CLI.

Counterpart of ``raht3dgs_tpu/cli/encode_3dgs.py``: reads a voxelized-3DGS
PLY (from ``voxelize_3dgs``), runs the RD sweep over all 56 attribute
channels on CUDA (unless ``--platform cpu``) and logs the reference's
19-column CSV; ``--render`` renders the finest step's reconstruction
against the input scene (``auto`` takes the package's own volumetric
rasterizer, named ``jax``, when gsplat is absent). Example:

    python -m raht3dgs_tpu_torch.cli.encode_3dgs \\
        --input output_compressed/compressed_Nvox_gaussians.ply --depth 10

``--entropy rac|auto`` picks the attribute coder per channel, and
``--code-geometry`` with ``--save-streams`` attaches one lossless geometry
section to every step's stream (``decode --color-space 3dgs`` then needs
no ``--positions``: the header's ``width`` and ``vmin`` carry the world
mapping). ``--predict`` codes inter-depth predicted RAHT (the device
encoder on the card). ``--target-bpp T`` replaces the sweep by a search for
the step that meets the rate (``models/rd_search.py``; the
``--per-attribute`` multipliers apply to the searched step), written as
``gs_bppT.r3tc`` with ``--save-streams``. ``--tiles D`` (with
``--save-streams`` and one ``--steps`` value) writes one tiled
``gs_tiledD_stepS.r3tt`` of octree bricks at depth D, the world mapping in
its shared header (``decode --roi`` / ``--color-space 3dgs``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from raht3dgs_tpu_torch.cli._common import (
    CsvLogger,
    add_geometry_arg,
    add_quant_args,
    add_runtime_args,
    maybe_profile,
    quant_kwargs,
    torch_dtype,
)
from raht3dgs_tpu_torch.config import GsCodecConfig
from raht3dgs_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="voxelized 3DGS PLY")
    p.add_argument("--depth", type=int, default=GsCodecConfig.depth)
    p.add_argument("--steps", type=float, nargs="+", default=list(GsCodecConfig.steps))
    p.add_argument(
        "--per-attribute", action="store_true",
        help="importance-weighted per-attribute-group quantization "
        "(encode_3dgs_debug strategy)",
    )
    p.add_argument(
        "--render", choices=("auto", "gsplat", "jax", "preview", "none"),
        default="none",
        help="render comparison of the finest step's reconstruction against "
        "the input ('jax': the package's own volumetric rasterizer)",
    )
    p.add_argument("--save-streams", default=None,
                   help="directory to write .r3tc frame bitstreams")
    p.add_argument(
        "--entropy-chunk", type=int, default=0,
        help="entropy-code each of the 56 channels in independent chunks of "
        "this many symbols (0 = sequential)",
    )
    p.add_argument(
        "--target-bpp", type=float, default=None,
        help="instead of --steps, search the quantization step hitting this "
        "rate budget (honors --per-attribute multipliers)",
    )
    p.add_argument(
        "--tiles", type=int, default=0, metavar="D",
        help="partition the frame into octree bricks at depth D and write one "
        "tiled .r3tt stream (decode --roi reads a brick subset). Requires "
        "--save-streams and exactly one --steps value; not with --target-bpp",
    )
    add_geometry_arg(p)
    add_quant_args(p)
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    with maybe_profile(args, device):
        return _run(args, device)


def per_attribute_scales():
    """Step multipliers of ``--per-attribute``: importance ~ 1/ablation-PSNR,
    multiplier = min importance / the group's, in (0, 1]."""
    from raht3dgs_tpu_torch.ops.quantize import GS_ABLATION_PSNR_DB

    imp = {k: 1.0 / v for k, v in GS_ABLATION_PSNR_DB.items()}
    imp_min = min(imp.values())
    return {k: imp_min / imp[k] for k in imp}


def _run(args, device) -> int:
    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply
    from raht3dgs_tpu_torch.models.gs_codec import CSV_HEADER, encode_gs_frame
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec

    V_int, attrs, voxel_size, vmin = read_compressed_3dgs_ply(args.input)
    print(f"loaded {len(V_int)} voxels, {attrs.shape[1]} channels "
          f"(voxel_size={voxel_size}, vmin={vmin})")
    group_scales = None
    if args.per_attribute:
        group_scales = per_attribute_scales()
        print("per-attribute step multipliers:", group_scales)

    dtype = torch_dtype(args.dtype)
    codec = AttributeCodec(args.depth, dtype=dtype, chunk=args.entropy_chunk,
                           device=device, **quant_kwargs(args))
    if args.tiles:
        if args.target_bpp is not None:
            raise SystemExit("--tiles and --target-bpp do not combine "
                             "(tile at the searched step in two runs)")
        return _encode_tiled_gs(args, codec, V_int, attrs, voxel_size, vmin, group_scales,
                                device)
    if args.target_bpp is not None:
        return _search(args, codec, V_int, attrs, voxel_size, vmin, group_scales, device)
    points = encode_gs_frame(
        V_int, attrs, depth=args.depth, steps=args.steps,
        group_step_scales=group_scales, bucket=args.bucket, dtype=dtype,
        keep_streams=bool(args.save_streams or args.render != "none"), codec=codec,
        vmin=vmin, width=float(voxel_size) * (1 << args.depth),
    )
    geom = None
    if args.code_geometry and args.save_streams:
        geom = geometry_from_positions(V_int, args.depth)
        print(f"geometry {len(geom) * 8.0 / len(V_int):.3f} bits/voxel (lossless)")
    log = CsvLogger(args.csv or "results/runtime_3dgs.csv", CSV_HEADER)
    for pt in points:
        log.row(pt.csv_row())
        print(
            f"step {pt.step:g}: {pt.bpp:.4f} bpp | PSNR all "
            f"{pt.psnr['psnr_all']:.2f} dB (quats {pt.psnr['psnr_quats']:.2f}, "
            f"scales {pt.psnr['psnr_scales']:.2f}, opacity "
            f"{pt.psnr['psnr_opacity']:.2f}, colors {pt.psnr['psnr_colors']:.2f})"
        )
        if args.save_streams and pt.encoded is not None:
            out = Path(args.save_streams)
            out.mkdir(parents=True, exist_ok=True)
            if geom is not None:
                pt.encoded.stream.geometry = geom
            (out / f"gs_step{pt.step:g}.r3tc").write_bytes(pt.encoded.stream.to_bytes())
    log.close()

    if args.render != "none":
        render_finest(args, points, codec, V_int, attrs, voxel_size, vmin, device)
    return 0


def _encode_tiled_gs(args, codec, V_int, attrs, voxel_size, vmin, group_scales,
                     device) -> int:
    """--tiles: one 56-channel .r3tt tiled frame and its 19-column CSV row;
    the world mapping rides the shared header (width = voxel_size * 2**J,
    the true vmin), so any brick subset decodes in frame coordinates."""
    import time

    import numpy as np

    from raht3dgs_tpu_torch.eval.metrics import gs_group_psnr
    from raht3dgs_tpu_torch.models.gs_codec import CSV_HEADER, GsRDPoint
    from raht3dgs_tpu_torch.models.tiling import decode_tiled_frame, encode_tiled_frame
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np
    from raht3dgs_tpu_torch.ops.quantize import channel_steps

    if not args.save_streams:
        raise SystemExit("--tiles writes a .r3tt stream; pass --save-streams")
    if len(args.steps) != 1:
        raise SystemExit("--tiles requires exactly one --steps value")
    step = float(args.steps[0])
    step_vec = (channel_steps(attrs.shape[1], step,
                              {k: step * m for k, m in group_scales.items()})
                if group_scales else step)
    t0 = time.perf_counter()
    blob, stats = encode_tiled_frame(
        V_int, attrs, args.depth, args.tiles, codec, step_vec,
        code_geometry=bool(args.code_geometry), vmin=vmin,
        width=float(voxel_size) * (1 << args.depth))
    enc_s = time.perf_counter() - t0
    out = Path(args.save_streams)
    out.mkdir(parents=True, exist_ok=True)
    dst = out / f"gs_tiled{args.tiles}_step{step:g}.r3tt"
    dst.write_bytes(blob)
    n = len(V_int)
    _, A = decode_tiled_frame(blob, positions=None if args.code_geometry else V_int,
                              dtype=codec.dtype, bucket=args.bucket, device=device)
    order = np.argsort(morton_codes_np(V_int, args.depth), kind="stable")
    psnr = gs_group_psnr(np.asarray(attrs, dtype=np.float64)[order], A)
    print(f"{len(stats)} tiles (brick depth {args.tiles}), {len(blob)} B = "
          f"{8 * len(blob) / n:.4f} bpp, PSNR all {psnr['psnr_all']:.2f} dB "
          f"(quats {psnr['psnr_quats']:.2f}, scales {psnr['psnr_scales']:.2f}, "
          f"opacity {psnr['psnr_opacity']:.2f}, colors {psnr['psnr_colors']:.2f}) -> {dst}")
    log = CsvLogger(args.csv or "results/runtime_3dgs.csv", CSV_HEADER)
    log.row(GsRDPoint(frame=1, step=step, bpp=8 * len(blob) / n, psnr=psnr, n_voxels=n,
                      stream_bytes=len(blob), times={"Entropy_enc_time": enc_s}).csv_row())
    log.close()
    return 0


def _search(args, codec, V_int, attrs, voxel_size, vmin, group_scales, device) -> int:
    """--target-bpp: the step that meets the budget, printed, and its
    stream saved (with the geometry under --code-geometry)."""
    import numpy as np

    from raht3dgs_tpu_torch.codec.geometry import geometry_from_positions
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.models.rd_search import search_step_for_bpp
    from raht3dgs_tpu_torch.ops.quantize import channel_steps

    if tuple(args.steps) != tuple(GsCodecConfig.steps):
        print("note: --steps ignored in --target-bpp mode", file=sys.stderr)
    frame = prepare_voxel_frame(V_int, attrs.astype(np.float64), args.depth,
                                bucket=args.bucket, dtype=codec.dtype, vmin=vmin,
                                width=float(voxel_size) * (1 << args.depth), device=device)
    D = attrs.shape[1]

    def steps_fn(step):
        if group_scales:
            return channel_steps(D, float(step),
                                 {k: float(step) * m for k, m in group_scales.items()})
        return float(step)

    res = search_step_for_bpp(frame, args.target_bpp, codec=codec, steps_fn=steps_fn)
    print(f"target {args.target_bpp:.3f} bpp -> step {res.step:.4f}, "
          f"actual {res.bpp:.3f} bpp ({res.probes} device probes)")
    if args.save_streams:
        out = Path(args.save_streams)
        out.mkdir(parents=True, exist_ok=True)
        st = res.encoded.stream
        if args.code_geometry:
            st.geometry = geometry_from_positions(V_int, args.depth)
            print(f"geometry {st.geometry_bpp():.3f} bits/voxel (lossless)")
        dest = out / f"gs_bpp{args.target_bpp:g}.r3tc"
        dest.write_bytes(st.to_bytes())
        print(f"stream -> {dest}")
    return 0


def render_finest(args, points, codec, V_int, attrs, voxel_size, vmin, device) -> None:
    """Decode the finest step and render it against the input scene, both
    at the voxel centres, the reference's world mapping."""
    import numpy as np

    from raht3dgs_tpu_torch.eval.render import render_comparison
    from raht3dgs_tpu_torch.models.pipeline import prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    finest = min(points, key=lambda p: p.step)
    frame = prepare_voxel_frame(V_int, attrs.astype(np.float64), args.depth,
                                bucket=args.bucket, dtype=codec.dtype, device=device)
    rec, _ = codec.decode(finest.encoded.stream, frame.codes, frame.weights)
    world = (V_int.astype(np.float64) + 0.5) * voxel_size + vmin
    # decoded rows are in Morton order; re-sort the originals to match
    sort = np.argsort(morton_codes_np(V_int, args.depth), kind="stable")
    original = {
        "means": world[sort],
        "quats": attrs[sort, 0:4],
        "scales": attrs[sort, 4:7],
        "opacities": attrs[sort, 7],
        "colors": attrs[sort, 8:],
    }
    recon = {
        "means": world[sort],
        "quats": rec[:, 0:4],
        "scales": np.abs(rec[:, 4:7]),
        "opacities": np.clip(rec[:, 7], 0, 1),
        "colors": rec[:, 8:],
    }
    m = render_comparison(original, recon, backend=args.render, device=device)
    if m:
        print(f"render PSNR ({m['backend']}): {m['psnr_avg']:.2f} dB")


if __name__ == "__main__":
    sys.exit(main())
