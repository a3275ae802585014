"""Golden-reference cross-check harness (MATLAB / reference-Python parity).

Counterpart of ``raht3dgs_tpu/crosscheck.py``: load the MATLAB reference's
``.mat`` dumps (cell arrays of per-level List / Flags / weights,
coefficient matrices) through scipy, compute the port's equivalents (the
host golden prelude of ``ops/prelude.py``, or the coefficients of a
transform such as the dense ``ops/raht.py`` on the card), and compare them
at the reference's tolerances: coefficients allclose at rtol = atol =
1e-12, weights and structures exact, index lists aligned between 0- and
1-based numbering. ``save_lists`` / ``save_mat`` write dumps the reference
tooling reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# Reference tolerances (crosscheck.py:365-366,420).
COEFF_RTOL = 1e-12
COEFF_ATOL = 1e-12


@dataclass
class CompareResult:
    name: str
    ok: bool
    detail: str = ""
    max_abs_diff: float = 0.0

    def __str__(self) -> str:
        status = "OK " if self.ok else "FAIL"
        extra = f" (max|diff|={self.max_abs_diff:.3e})" if self.max_abs_diff else ""
        return f"[{status}] {self.name}: {self.detail}{extra}"


@dataclass
class CrosscheckReport:
    results: List[CompareResult] = field(default_factory=list)

    def add(self, r: CompareResult) -> None:
        self.results.append(r)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def __str__(self) -> str:
        return "\n".join(str(r) for r in self.results)


def _require_scipy():
    try:
        from scipy import io as sio  # noqa: F401

        return sio
    except ImportError as e:  # pragma: no cover
        raise ImportError("scipy is required for .mat cross-checking") from e


def load_mat(path) -> Dict[str, np.ndarray]:
    sio = _require_scipy()
    raw = sio.loadmat(path, squeeze_me=False)
    return {k: v for k, v in raw.items() if not k.startswith("__")}


def save_mat(array: np.ndarray, path, key: str = "data") -> None:
    sio = _require_scipy()
    sio.savemat(path, {key: np.asarray(array)})


def save_lists(path, **named_lists: Sequence[np.ndarray]) -> None:
    """Save ragged per-level lists as MATLAB cell arrays (object arrays)."""
    sio = _require_scipy()
    out = {}
    for key, lists in named_lists.items():
        cell = np.empty((len(lists), 1), dtype=object)
        for i, a in enumerate(lists):
            cell[i, 0] = np.asarray(a)
        out[key] = cell
    sio.savemat(path, out)


def cells_to_lists(cell: np.ndarray) -> List[np.ndarray]:
    """Flatten a MATLAB cell array (object ndarray) into a list of 1-D arrays."""
    cell = np.asarray(cell)
    flat = cell.ravel()
    return [np.asarray(x).ravel() for x in flat]


def _index_base_offset(a: np.ndarray, b: np.ndarray) -> int:
    """Detect a constant 0/1-base offset between two index arrays."""
    if a.size == 0 or b.size == 0 or a.size != b.size:
        return 0
    d = b.astype(np.int64) - a.astype(np.int64)
    return int(d[0]) if np.all(d == d[0]) and abs(d[0]) <= 1 else 0


def compare_tensor(
    name: str,
    a: np.ndarray,
    b: np.ndarray,
    rtol: float = COEFF_RTOL,
    atol: float = COEFF_ATOL,
    exact: bool = False,
) -> CompareResult:
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return CompareResult(name, False, f"shape {a.shape} vs {b.shape}")
    if a.size == 0:
        return CompareResult(name, True, "empty")
    diff = float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))
    if exact:
        ok = bool(np.array_equal(a, b))
        return CompareResult(name, ok, "exact" if ok else "mismatch", diff)
    ok = bool(np.allclose(a, b, rtol=rtol, atol=atol))
    return CompareResult(
        name, ok, f"allclose rtol={rtol:g} atol={atol:g}", diff
    )


def compare_level_lists(
    name: str,
    mine: Sequence[np.ndarray],
    theirs: Sequence[np.ndarray],
    index_like: bool = False,
) -> List[CompareResult]:
    """Per-level exact comparison with 0/1-base auto-alignment for indices
    (the MATLAB dumps are 1-based; reference crosscheck.py:163-182)."""
    out: List[CompareResult] = []
    if len(mine) != len(theirs):
        out.append(
            CompareResult(
                name, False, f"level count {len(mine)} vs {len(theirs)}"
            )
        )
        return out
    for j, (a, b) in enumerate(zip(mine, theirs)):
        a = np.asarray(a).ravel()
        b = np.asarray(b).ravel()
        if index_like:
            off = _index_base_offset(a, b)
            b = b - off
        out.append(
            compare_tensor(f"{name}[{j}]", a.astype(np.int64),
                           b.astype(np.int64), exact=True)
        )
    return out


def crosscheck_prelude(
    codes: np.ndarray,
    depth: int,
    mat_path,
    list_key: str = "ListC",
    flags_key: str = "FlagsC",
    weights_key: str = "weightsC",
) -> CrosscheckReport:
    """Compare our prelude structures against a MATLAB dump
    (``matlab/encode_ply.m`` writes ListC/FlagsC/weightsC cells)."""
    from raht3dgs_tpu_torch.ops.prelude import prelude

    Lists, Flags, weights, _ = prelude(np.asarray(codes), 3 * depth)
    mat = load_mat(mat_path)
    report = CrosscheckReport()
    for r in compare_level_lists(
        "List", Lists, cells_to_lists(mat[list_key]), index_like=True
    ):
        report.add(r)
    for r in compare_level_lists(
        "Flags",
        [f.astype(np.int64) for f in Flags],
        cells_to_lists(mat[flags_key]),
    ):
        report.add(r)
    for r in compare_level_lists(
        "weights", weights, cells_to_lists(mat[weights_key])
    ):
        report.add(r)
    return report


def crosscheck_coefficients(
    coeffs: np.ndarray,
    mat_path,
    key: str = "data",
    weights: Optional[np.ndarray] = None,
    weights_mat: Optional[np.ndarray] = None,
) -> CrosscheckReport:
    """Coefficients allclose @1e-12; node weights exact (crosscheck.py:363-440)."""
    mat = load_mat(mat_path)
    report = CrosscheckReport()
    report.add(compare_tensor("T", coeffs, mat[key]))
    if weights is not None and weights_mat is not None:
        report.add(
            compare_tensor(
                "w", np.asarray(weights).ravel(),
                np.asarray(weights_mat).ravel(), exact=True,
            )
        )
    return report
