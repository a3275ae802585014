#!/usr/bin/env python3
"""Verify that a PLY file's points are in Morton (Z-order) order, with the
PyTorch port's reader and Morton coder.

The port's counterpart of ``scripts/check_morton.py``: the same arguments,
printed lines and exit code (0 when Morton-ordered, 1 otherwise). It reads
a point cloud, computes Morton codes on the host (numpy, digit = z + 2y +
4x per level), and reports how many consecutive pairs are out of order.

    python scripts/torch_check_morton.py frame.ply [--depth J]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ply", help="PLY file to check")
    ap.add_argument(
        "--depth", type=int, default=None,
        help="octree depth (default: from header width comment, else from "
        "coordinate range)",
    )
    args = ap.parse_args(argv)

    import numpy as np

    from raht3dgs_tpu_torch.io.ply import read_ply
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np

    ply = read_ply(args.ply)
    v = ply.vertices
    V = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)

    # shift to the bounding-box origin before encoding, as the reference's
    # verdict is defined: negative coordinates would otherwise feed
    # two's-complement bits into the interleave
    Vs = V - V.min(axis=0, keepdims=True)
    depth = args.depth
    if depth is None:
        tok = ply.comment_value("width")
        if tok:
            depth = int(np.log2(int(tok[0]) + 1))
        else:
            depth = max(1, int(np.ceil(np.log2(Vs.max() + 1))))
    codes = morton_codes_np(np.floor(Vs).astype(np.int64), depth)

    bad = int(np.sum(codes[1:] < codes[:-1]))
    dup = int(np.sum(codes[1:] == codes[:-1]))
    n = len(codes)
    print(f"{args.ply}: {n} points, depth J={depth}")
    print(f"out-of-order consecutive pairs: {bad} ({bad / max(n - 1, 1):.2%})")
    print(f"duplicate consecutive codes:    {dup}")
    print("Morton-ordered." if bad == 0 else "NOT Morton-ordered.")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
