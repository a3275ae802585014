#!/usr/bin/env python3
"""Full-grid 3DGS RD parity of the PyTorch port at the reference's
operating point, through the CLI: J=10, the 9-step grid
{1,4,8,12,16,20,24,32,64}, a ~500k-voxel frame, 56 channels.

The port's counterpart of ``scripts/rd_parity_3dgs_full.py``:

- writes the JAX tool's frame (``eval/synth.synthetic_gs_frame``, float32
  on disk) as a voxelized-3DGS PLY (62-float binary records + voxel
  metadata comments);
- runs both port legs as ``python -m raht3dgs_tpu_torch.cli.encode_3dgs``
  subprocesses (float64, the CLI's defaults), each timed: the parity leg
  (``RAHT3DGS_RAHT_IMPL=golden``) and the span leg (the default device
  path), producing the 19-column CSV and ``.r3tc`` streams;
- byte-compares all 56 channel payloads of the two legs' streams per step,
  counting the symbols that differ;
- with ``--reference PATH``, runs the upstream reference's PyTorch
  pipeline on the same file with the port's RLGR coder (a PATH that does
  not exist is an error, never a skip); without it the reference columns
  read ``not run``, apart from span Δbpp, the span leg's rate against the
  parity leg's (``torch_rd_parity_j18.py:parity_rows``);
- with ``--against docs/rd_parity_3dgs_full.md``, holds the parity leg's
  bpp and PSNR and the span Δbpp against the JAX document and requires
  the two legs' streams to be equal wherever the document's span Δbpp is 0.

    python scripts/torch_rd_parity_3dgs_full.py [--device cuda|cpu] \
        [--out F] [--against docs/rd_parity_3dgs_full.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_rd_deadzone import add_port_args, finish_report, run_line  # noqa: E402
from torch_rd_parity_check import check_reference  # noqa: E402
from torch_rd_parity_j18 import (  # noqa: E402
    SPAN_TABLE,
    parity_ok,
    parity_rows,
    run_legs,
    span_verdict,
    verdict_lines,
)


def reference_leg(ply_path, depth, steps, reference):
    """The upstream reference's pipeline on the same file, with the port's
    RLGR coder: ([(bpp, PSNR_all, [channel bytes x D])], N)."""
    sys.path.insert(0, reference)
    import numpy as np
    import torch
    from RAHT import RAHT2_optimized
    from RAHT_param import RAHT_param_reorder_fast
    from data_util import read_compressed_3dgs_ply
    from iRAHT import inverse_RAHT_optimized

    from raht3dgs_tpu_torch.codec.rlgr import rlgr_encode

    V_int, C, _voxel_size, _vmin = read_compressed_3dgs_ply(ply_path)
    N = V_int.shape[0]
    C = C.to(torch.float64)
    Lists, Flags, weights, order = RAHT_param_reorder_fast(
        V_int.to(torch.float64), torch.zeros(3, dtype=torch.float64), 2**depth, depth)
    Coeff, _ = RAHT2_optimized(C, Lists, Flags, weights)
    rows = []
    for step in steps:
        q = torch.floor(Coeff / step + 0.5)
        reordered = q.index_select(0, order).to(torch.int64).numpy()
        chans = [rlgr_encode(reordered[:, d])[0] for d in range(C.shape[1])]
        C_rec = inverse_RAHT_optimized(q * step, Lists, Flags, weights)
        mse = float(torch.mean((C - C_rec) ** 2))
        rows.append((sum(len(c) for c in chans) * 8.0 / N,
                     -10.0 * np.log10(mse + 1e-10), chans))
    return rows, N


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--steps", type=float, nargs="+",
                    default=[1, 4, 8, 12, 16, 20, 24, 32, 64])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", default=None,
                    help="the upstream reference's python tree; its leg runs "
                    "only when given, and a missing tree is an error")
    ap.add_argument("--csv", default="results/port/runtime_3dgs_full.csv")
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep", default=None)
    add_port_args(ap)
    args = ap.parse_args(argv)
    reference = check_reference(args.reference)

    t0 = time.perf_counter()
    from raht3dgs_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    import numpy as np

    from raht3dgs_tpu_torch.eval.synth import synthetic_gs_frame
    from raht3dgs_tpu_torch.io.ply import save_ply_3dgs

    workdir = args.keep or tempfile.mkdtemp(prefix="torch_rd_parity_3dgs_")
    os.makedirs(workdir, exist_ok=True)
    ply_path = os.path.join(workdir, f"gs_j{args.depth}.ply")
    V, attrs = synthetic_gs_frame(args.n, args.depth, args.seed)
    attrs = attrs.astype(np.float32)  # the on-disk record is float32
    save_ply_3dgs(
        ply_path,
        means=V.astype(np.float64),
        quats=attrs[:, 0:4],
        scales=attrs[:, 4:7],
        opacities=attrs[:, 7],
        colors=attrs[:, 8:],
        voxel_size=1.0 / (1 << args.depth),
        vmin=np.zeros(3),
    )
    print(f"wrote {ply_path}: {len(V)} voxels, 56 channels")

    csv_path = os.path.join(REPO, args.csv)
    os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    legs = run_legs("raht3dgs_tpu_torch.cli.encode_3dgs",
                    ["--input", ply_path, "--depth", str(args.depth)], dev,
                    workdir, csv_path, args.steps)
    ref_rows, n = (reference_leg(ply_path, args.depth, args.steps, reference)
                   if reference else (None, len(V)))
    rows, span_rows, summ = parity_rows(
        args.steps, legs, lambda s: f"gs_step{s:g}.r3tc", "PSNR_all", ref_rows)
    span_bad = span_verdict(args, summ)

    report = "\n".join([
        "# 3DGS RD parity at the reference's full operating point (PyTorch port)",
        "",
        f"Config: **J={args.depth}, steps "
        f"{{{', '.join(f'{s:g}' for s in args.steps)}}}, N={n} voxels, "
        "56 channels** — the reference's 3DGS configuration. Content: "
        "fractal-correlated synthetic 3DGS frame (eval/synth.py) written "
        "as a float32 compressed-3DGS PLY.",
        "",
        "Port legs through `python -m raht3dgs_tpu_torch.cli.encode_3dgs "
        f"--platform {dev.type}` subprocesses (float64; CSV `{args.csv}`; "
        "streams on disk): parity leg (`RAHT3DGS_RAHT_IMPL=golden`, "
        f"{legs['golden'][2]:.1f} s) and span leg ({legs['span'][2]:.1f} s). "
        "Reference leg: "
        + ("the upstream reference's PyTorch pipeline imported from "
           f"`{reference}` with the port's RLGR coder." if reference else
           "not run (no `--reference`; it waits for the upstream reference "
           "tree)."),
        "",
        run_line("torch_rd_parity_3dgs_full.py", dev, t0),
        "",
        "| step | ref bpp | ours bpp | Δbpp | ref PSNR | ours PSNR "
        "| ΔPSNR | streams == | span Δbpp | span ΔPSNR |",
        "|---|---|---|---|---|---|---|---|---|---|",
        *rows,
        "",
        "The span leg against the parity leg ('symbols that differ' counts "
        "the decoded symbols of all 56 channels that are not equal; their "
        "ties are not counted here):",
        "",
        *SPAN_TABLE,
        *span_rows,
        "",
        *verdict_lines(args, reference, summ, span_bad),
    ])
    print(report)
    ok = parity_ok(reference, summ, span_bad, 1e-5)
    rc = finish_report(args, report)
    if args.keep is None:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return rc if ok else 1


if __name__ == "__main__":
    sys.exit(main())
