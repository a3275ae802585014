"""Research CLI: the per-attribute quantization study of the 3DGS payload.

Counterpart of ``raht3dgs_tpu/cli/encode_3dgs_debug.py``: prints the three
step-allocation strategies for the actual coefficient ranges, then encodes
with one strategy's per-attribute steps and reports rate and per-group
PSNR, on CUDA unless ``--platform cpu``; with ``--ablation``, measures
which attribute group's quantization error hurts rendering most (one
reconstructed group at a time through the render comparison). Example:

    python -m raht3dgs_tpu_torch.cli.encode_3dgs_debug \\
        --input compressed_Nvox_gaussians.ply --depth 10 --ablation
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from raht3dgs_tpu_torch.cli._common import (
    add_runtime_args,
    maybe_profile,
    torch_dtype,
)
from raht3dgs_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="voxelized 3DGS PLY")
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--uniform-step", type=float, default=8.0,
                   help="uniform step to contrast the strategies against")
    p.add_argument("--level-budget", type=int, default=1024)
    p.add_argument("--target-levels", type=int, default=256)
    p.add_argument("--strategy", choices=("range", "importance", "hybrid"),
                   default="importance")
    p.add_argument("--ablation", action="store_true",
                   help="run the per-attribute rendering ablation")
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--render", choices=("auto", "gsplat", "jax", "preview", "none"),
                   default="auto", help="renderer of --ablation")
    add_runtime_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    with maybe_profile(args, device):
        return _run(args, device)


def _run(args, device) -> int:
    from raht3dgs_tpu_torch.eval.metrics import gs_group_psnr
    from raht3dgs_tpu_torch.io.ply import read_compressed_3dgs_ply
    from raht3dgs_tpu_torch.models.gs_quant_analysis import (
        attribute_ablation,
        coefficient_ranges,
        per_group_step_vector,
        quantization_strategy_report,
        strategy_hybrid,
        strategy_importance_weighted,
        strategy_range_normalized,
    )
    from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
    from raht3dgs_tpu_torch.ops.morton import morton_codes_np

    V_int, attrs, voxel_size, vmin = read_compressed_3dgs_ply(args.input)
    dtype = torch_dtype(args.dtype)
    depth = args.depth
    frame = prepare_voxel_frame(V_int, attrs.astype(np.float64), depth,
                                bucket=args.bucket, dtype=dtype, device=device)
    codec = AttributeCodec(depth, dtype=dtype, device=device)
    coeffs, order, _, _ = codec.transform(frame)
    coeffs_np = coeffs[:frame.n_voxels].cpu().numpy()
    print(quantization_strategy_report(coeffs_np, args.uniform_step, args.target_levels,
                                       args.level_budget))

    ranges = coefficient_ranges(coeffs_np)
    s_range = strategy_range_normalized(ranges, args.target_levels)
    s_imp, _ = strategy_importance_weighted(ranges, args.level_budget)
    steps_by_group = {
        "range": s_range,
        "importance": s_imp,
        "hybrid": strategy_hybrid(s_range, s_imp),
    }[args.strategy]
    step_vec = per_group_step_vector(steps_by_group, attrs.shape[1])

    enc = codec.encode(frame, steps=step_vec, coeffs=coeffs, order=order)
    rec, _ = codec.decode(enc.stream, frame.codes, frame.weights)
    sort = np.argsort(morton_codes_np(V_int, depth), kind="stable")
    ref_sorted = attrs[sort].astype(np.float64)
    psnr = gs_group_psnr(ref_sorted, rec)
    print(f"\n=== {args.strategy.upper()} STRATEGY ENCODE ===")
    print(f"rate: {enc.stream.bpp():.4f} bpp ({enc.stream.payload_bytes} bytes)")
    for k in ("psnr_all", "psnr_quats", "psnr_scales", "psnr_opacity", "psnr_colors"):
        print(f"  {k}: {psnr[k]:.2f} dB")

    if args.ablation:
        # voxel centres, the reference's world mapping
        world = (V_int[sort].astype(np.float64) + 0.5) * voxel_size + vmin
        print("\n=== RENDERING ABLATION (one reconstructed group at a time) ===")
        result = attribute_ablation(world, ref_sorted, rec, n_views=args.views,
                                    image_size=args.image_size, backend=args.render,
                                    device=device)
        for name, p in sorted(result.items(), key=lambda kv: kv[1]):
            print(f"  {name:8s}: {p:.2f} dB")
        worst = min(result, key=result.get)
        print(f"most impactful attribute: {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
