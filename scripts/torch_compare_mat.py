#!/usr/bin/env python3
"""Generic .mat diff tool, with the PyTorch port's ``.mat`` loader.

The port's counterpart of ``scripts/compare_mat.py``: compares every shared
variable in two MATLAB files with allclose and max / mean abs-diff
reporting, descending into cell arrays; char / string variables compare
exactly, and NaNs at the same place compare equal. The same arguments,
printed lines and exit code (0 when every shared variable matches).

    python scripts/torch_compare_mat.py a.mat b.mat --rtol 1e-8 --atol 1e-12
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compare_values(name, a, b, rtol, atol):
    import numpy as np

    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == object or b.dtype == object:
        fa, fb = a.ravel(), b.ravel()
        if fa.shape != fb.shape:
            print(f"  {name}: cell count {fa.shape} vs {fb.shape}  FAIL")
            return False
        ok = True
        for i, (x, y) in enumerate(zip(fa, fb)):
            ok &= compare_values(f"{name}{{{i}}}", x, y, rtol, atol)
        return ok
    if a.shape != b.shape:
        print(f"  {name}: shape {a.shape} vs {b.shape}  FAIL")
        return False
    if a.size == 0:
        print(f"  {name}: empty  OK")
        return True
    if a.dtype.kind in "USO" or b.dtype.kind in "USO":
        # char / string / object variables (MATLAB metadata): exact
        ok = bool(np.array_equal(a, b))
        print(f"  {name}: {'OK  ' if ok else 'FAIL'} (non-numeric)")
        return ok
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    diff = np.abs(af - bf)
    close = np.isclose(af, bf, rtol=rtol, atol=atol, equal_nan=True)
    frac = float(close.mean())
    ok = bool(close.all())
    print(
        f"  {name}: {'OK  ' if ok else 'FAIL'} "
        f"equal-frac={frac:.6f} max|d|={diff.max():.3e} mean|d|={diff.mean():.3e}"
    )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mat1")
    ap.add_argument("mat2")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--atol", type=float, default=1e-12)
    args = ap.parse_args(argv)

    from raht3dgs_tpu_torch.crosscheck import load_mat

    m1 = load_mat(args.mat1)
    m2 = load_mat(args.mat2)
    shared = sorted(set(m1) & set(m2))
    only1 = sorted(set(m1) - set(m2))
    only2 = sorted(set(m2) - set(m1))
    if only1:
        print(f"only in {args.mat1}: {only1}")
    if only2:
        print(f"only in {args.mat2}: {only2}")
    if not shared:
        print("no shared variables")
        return 1
    ok = True
    print(f"comparing {len(shared)} shared variable(s):")
    for k in shared:
        ok &= compare_values(k, m1[k], m2[k], args.rtol, args.atol)
    print("ALL OK" if ok else "DIFFERENCES FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
