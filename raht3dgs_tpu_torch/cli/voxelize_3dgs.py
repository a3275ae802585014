"""3DGS voxelization CLI.

Counterpart of ``raht3dgs_tpu/cli/voxelize_3dgs.py``: a gsplat checkpoint
or a 3DGS PLY -> voxelize + merge on CUDA (unless ``--platform cpu``) ->
compressed PLY with voxel metadata -> the render comparison of the
original against the merged scene (``--render``; ``auto`` falls to the
package's own volumetric rasterizer, named ``jax`` as in the JAX package,
when gsplat is absent) -> the reference's 15-column runtime CSV. Example:

    python -m raht3dgs_tpu_torch.cli.voxelize_3dgs --ckpt ckpt.pt \\
        --depth 10 --output-dir output_compressed --render auto
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from raht3dgs_tpu_torch.cli._common import (
    CsvLogger,
    add_runtime_args,
    maybe_profile,
)
from raht3dgs_tpu_torch.config import VoxelizeConfig
from raht3dgs_tpu_torch.utils.device import resolve_device

# The reference's 15-column schema.
CSV_HEADER = (
    "Checkpoint,J,N_original,N_vox,Compression_ratio,"
    "Voxel_time_ms,Voxel_sync_ms,Cluster_time_ms,Cluster_sync_ms,"
    "Merge_time_ms,Merge_sync_ms,Total_time_ms,"
    "Original_size_mb,Compressed_size_mb,Size_reduction_percent"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="gsplat checkpoint (.pt)")
    src.add_argument("--ply", help="3DGS PLY scene")
    p.add_argument("--depth", type=int, default=VoxelizeConfig.depth, help="octree depth J")
    p.add_argument("--output-dir", default=VoxelizeConfig.output_dir)
    p.add_argument(
        "--no-opacity-weighting", action="store_true",
        help="merge with uniform member weights instead of opacity",
    )
    p.add_argument(
        "--render", choices=("auto", "gsplat", "jax", "preview", "none"),
        default="auto",
        help="render-comparison backend ('jax': the package's own volumetric "
        "rasterizer, which 'auto' takes when gsplat is absent)",
    )
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--render-dir", default=None, help="save rendered views here")
    add_runtime_args(p)
    return p


def _load_params(args):
    if args.ckpt:
        from raht3dgs_tpu_torch.io.gsplat_ckpt import load_gsplat_checkpoint

        params = load_gsplat_checkpoint(args.ckpt)
        if params is None:
            raise SystemExit(f"could not load checkpoint {args.ckpt}")
        return params, os.path.basename(args.ckpt)
    from raht3dgs_tpu_torch.io.ply import read_3dgs_scene_ply

    # raw scenes keep their float world coordinates; a pre-voxelized PLY
    # gives voxel centres, (V + 0.5) * voxel_size + vmin
    means, attrs, voxel_meta = read_3dgs_scene_ply(args.ply)
    if voxel_meta is not None:
        voxel_size, vmin = voxel_meta
        means = (np.floor(means) + 0.5) * voxel_size + vmin
    params = {
        "means": means,
        "quats": attrs[:, 0:4].astype(np.float64),
        "scales": attrs[:, 4:7].astype(np.float64),
        "opacities": attrs[:, 7].astype(np.float64),
        "colors": attrs[:, 8:].astype(np.float64),
    }
    return params, os.path.basename(args.ply)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    with maybe_profile(args, device):
        return _run(args, device)


def _run(args, device) -> int:
    from raht3dgs_tpu_torch.models.gs_voxelize import compress_to_nvox, world_positions

    params, name = _load_params(args)
    result = compress_to_nvox(params, depth=args.depth,
                              weight_by_opacity=not args.no_opacity_weighting,
                              output_dir=args.output_dir, device=device)
    n, k = result.n_input, result.n_voxels
    total_ms = result.timer.get("voxelize_merge") * 1000
    print(f"Gaussians: {n} -> {k} ({n / max(k, 1):.2f}x), "
          f"voxelize+merge {total_ms:.2f} ms (fused)")

    orig_mb = comp_mb = reduction = 0.0
    if args.output_dir:
        orig = os.path.join(args.output_dir, "original_N_gaussians.ply")
        comp = os.path.join(args.output_dir, "compressed_Nvox_gaussians.ply")
        orig_mb = os.path.getsize(orig) / 1e6
        comp_mb = os.path.getsize(comp) / 1e6
        reduction = (1 - comp_mb / orig_mb) * 100 if orig_mb else 0.0
        print(f"Files: {orig_mb:.2f} MB -> {comp_mb:.2f} MB ({reduction:.1f}% smaller)")

    if args.render != "none":
        from raht3dgs_tpu_torch.eval.render import render_comparison

        r = slice(0, k)
        merged = {
            "means": world_positions(result),
            "quats": result.quats[r],
            "scales": result.scales[r],
            "opacities": result.opacities[r],
            "colors": result.colors[r],
        }
        metrics = render_comparison(
            params, merged, n_views=args.views, image_size=args.image_size,
            backend=args.render, output_dir=args.render_dir, device=device,
        )
        if metrics:
            print(
                f"Render PSNR ({metrics['backend']}): "
                f"{metrics['psnr_avg']:.2f} +- {metrics['psnr_std']:.2f} dB "
                f"[{metrics['psnr_min']:.2f}, {metrics['psnr_max']:.2f}]"
            )

    log = CsvLogger(args.csv or "results/runtime_voxelize_3dgs.csv", CSV_HEADER)
    log.row(
        f"{name},{args.depth},{n},{k},{n / max(k, 1):.4f},"
        f"{total_ms:.4f},0.0000,0.0000,0.0000,0.0000,0.0000,"
        f"{total_ms:.4f},{orig_mb:.4f},{comp_mb:.4f},{reduction:.4f}"
    )
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
