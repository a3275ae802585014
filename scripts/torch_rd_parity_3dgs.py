#!/usr/bin/env python3
"""56-channel 3DGS rate-distortion parity of the PyTorch port.

The port's counterpart of ``scripts/rd_parity_3dgs.py``: the same
Morton-ordered voxelized 3DGS frame (``eval/synth.synthetic_gs_frame``:
quats, scales, opacity, 48 SH colours; bucket 2^12) through the port's
56-channel codec (``models/gs_codec.encode_gs_frame``) at each step, with
the reference's all-channel PSNR (``-10 log10(mse + 1e-10)``).

- With ``--reference PATH`` the reference leg runs too (the upstream
  reference's PyTorch pipeline imported from PATH, the port's RLGR coder);
  a PATH that does not exist is an error (a nonzero exit), never a skip.
- Without it, the reference columns read ``not run`` and ``--against
  docs/rd_parity_3dgs.md`` holds the port's columns against the JAX
  package's committed table.

    python scripts/torch_rd_parity_3dgs.py [--n 20000] [--depth 10] \
        [--steps 1 4 8 16 32 64] [--device cuda|cpu] [--reference DIR] \
        [--out F] [--against docs/rd_parity_3dgs.md]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import add_port_args, finish_report, run_line  # noqa: E402
from torch_rd_against import NOT_RUN  # noqa: E402
from torch_rd_parity_check import check_reference  # noqa: E402


def reference_leg(reference, V, attrs, depth, steps):
    """The upstream reference's PyTorch pipeline on the same frame, with the
    port's RLGR coder: [(bpp, PSNR_all)] per step."""
    sys.path.insert(0, reference)
    import numpy as np
    import torch
    from RAHT import RAHT2_optimized
    from RAHT_param import RAHT_param_reorder_fast
    from iRAHT import inverse_RAHT_optimized

    from raht3dgs_tpu_torch.codec.rlgr import rlgr_encode

    n = len(V)
    Vt = torch.from_numpy(V).to(torch.float64)
    C = torch.from_numpy(attrs).to(torch.float64)
    Lists, Flags, weights, order = RAHT_param_reorder_fast(
        Vt, torch.zeros(3, dtype=torch.float64), 2**depth, depth)
    Coeff, _ = RAHT2_optimized(C, Lists, Flags, weights)
    out = []
    for step in steps:
        q = torch.floor(Coeff / step + 0.5)
        reordered = q.index_select(0, order).to(torch.int64).numpy()
        nbytes = sum(len(rlgr_encode(np.ascontiguousarray(reordered[:, d]))[0])
                     for d in range(C.shape[1]))
        rec = inverse_RAHT_optimized(q * step, Lists, Flags, weights).numpy()
        out.append((nbytes * 8 / n,
                    -10 * math.log10(float(np.mean((rec - attrs) ** 2)) + 1e-10)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[1, 4, 8, 16, 32, 64])
    ap.add_argument("--reference", default=None,
                    help="the upstream reference's python tree; its leg runs "
                    "only when given, and a missing tree is an error")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_port_args(ap)
    args = ap.parse_args(argv)
    reference = check_reference(args.reference)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import synthetic_gs_frame
    from raht3dgs_tpu_torch.models.gs_codec import encode_gs_frame

    V, attrs = synthetic_gs_frame(args.n, args.depth, args.seed)
    n = len(V)
    t1 = time.perf_counter()
    ours = encode_gs_frame(V.astype(np.int64), attrs, depth=args.depth,
                           steps=args.steps, bucket=1 << 12, device=dev)
    port_s = time.perf_counter() - t1
    ref = reference_leg(reference, V, attrs, args.depth, args.steps) if reference else None

    rows = []
    worst_bpp = worst_psnr = 0.0
    for i, step in enumerate(args.steps):
        o = ours[i]
        if ref is None:
            rows.append(f"| {step:g} | {NOT_RUN} | {o.bpp:.6f} | {NOT_RUN} "
                        f"| {NOT_RUN} | {o.psnr['psnr_all']:.4f} | {NOT_RUN} |")
            continue
        ref_bpp, ref_psnr = ref[i]
        d_bpp, d_psnr = abs(o.bpp - ref_bpp), abs(o.psnr["psnr_all"] - ref_psnr)
        worst_bpp, worst_psnr = max(worst_bpp, d_bpp), max(worst_psnr, d_psnr)
        rows.append(f"| {step:g} | {ref_bpp:.6f} | {o.bpp:.6f} | {d_bpp:.2e} "
                    f"| {ref_psnr:.4f} | {o.psnr['psnr_all']:.4f} | {d_psnr:.2e} |")

    report = "\n".join([
        "# 56-channel 3DGS RD parity vs the reference implementation (PyTorch port)",
        "",
        f"Synthetic Morton-ordered voxelized 3DGS frame: N={n}, "
        f"J={args.depth}, seed={args.seed}; [quats(4), scales(3), "
        "opacity(1), SH(48)]. Port leg: `encode_gs_frame` on "
        f"{dev.type} (float64, bucket 2^12), {port_s:.2f} s. Reference leg: "
        + (f"PyTorch pipeline imported from `{reference}` (RLGR via the port's "
           "coder)." if ref else "not run (no `--reference`; it waits for the "
           "upstream reference tree)."),
        "",
        run_line("torch_rd_parity_3dgs.py", dev, t0),
        "",
        "| step | ref bpp | ours bpp | Δbpp | ref PSNR_all | ours "
        "PSNR_all | ΔPSNR |",
        "|---|---|---|---|---|---|---|",
        *rows,
        "",
    ] + ([f"max |Δbpp| = {worst_bpp:.3e}, max |ΔPSNR| = {worst_psnr:.3e} dB", ""]
         if ref else []))
    print(report)
    ok = ref is None or (worst_bpp < 1e-9 and worst_psnr < 1e-6)
    if ref is not None:
        print("PARITY: OK" if ok else "PARITY: FAILED")
    rc = finish_report(args, report)
    return rc if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
