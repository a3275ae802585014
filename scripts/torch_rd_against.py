#!/usr/bin/env python3
"""Hold a port RD table against the JAX package's committed RD document.

Every port RD tool (``scripts/torch_rd_*.py``) takes ``--against
docs/rd_<name>.md`` and compares through this module, and through nothing
else:

- It reads the markdown tables of both documents, in order, and pairs each
  table of the port's output with the next table of the JAX document whose
  header is the same. A document's tables without a counterpart are named
  (the JAX documents carry hand-written tables no tool prints).
- Paired tables must have the same rows; their cells are compared as
  printed. Columns that are a machine's times or rates (a header naming
  ``s``, ``ms``, ``Mpts/s`` or ``Msym/s``) are skipped and named, and so are
  the columns whose cells the port printed as ``not run`` (a parity tool's
  reference leg, which waits for the reference tree).
- Cells of a bpp or PSNR column are compared as numbers and the largest
  |Δbpp| and |ΔPSNR| are printed. A bpp must be equal as printed; a PSNR
  must stay within ``--psnr-tol`` (0 by default: equal as printed). Every
  other cell must be equal as printed.
- The BD-rate statements (``BD-rate ... -12.34%``) of both documents are
  compared in order, equal as printed.

It prints a verdict and exits nonzero on any difference, or when no table
paired.

    python scripts/torch_rd_against.py docs/rd_deadzone.md docs/port/rd_deadzone.md
"""

from __future__ import annotations

import argparse
import re
import sys
from dataclasses import dataclass, field
from typing import List, Tuple

NOT_RUN = "not run"
_TIME = re.compile(r"(?<![\w/])(?:ms|s|Mpts/s|Msym/s)(?![\w])")
_BD = re.compile(r"BD-rate\s*(\([^)]*\))?\s*:?\s*([+-]?\d+(?:\.\d+)?)%")
_FLOAT = re.compile(r"[+-]?\d+(?:\.\d+)?(?:e[+-]?\d+)?%?")


@dataclass
class Table:
    header: List[str]
    rows: List[List[str]] = field(default_factory=list)
    line: int = 0


def _cells(line: str) -> List[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def read_tables(text: str) -> List[Table]:
    """The markdown tables of ``text``, in order: a header row, a ``|---|``
    rule, then the body rows."""
    lines = text.splitlines()
    out, i = [], 0
    while i < len(lines):
        if (lines[i].lstrip().startswith("|") and i + 1 < len(lines)
                and re.fullmatch(r"\s*\|(\s*:?-+:?\s*\|)+\s*", lines[i + 1])):
            t = Table(_cells(lines[i]), line=i + 1)
            i += 2
            while i < len(lines) and lines[i].lstrip().startswith("|"):
                t.rows.append(_cells(lines[i]))
                i += 1
            out.append(t)
        else:
            i += 1
    return out


def bd_rates(text: str) -> List[Tuple[str, str]]:
    """Every ``BD-rate (label): -12.34%`` statement, as (label, number)."""
    return [(m.group(1) or "", m.group(2)) for m in _BD.finditer(text)]


def is_time_column(name: str) -> bool:
    return bool(_TIME.search(name))


def _number(cell: str):
    return float(cell.rstrip("%")) if _FLOAT.fullmatch(cell) else None


def compare(doc_text: str, port_text: str,
            psnr_tol: float = 0.0) -> Tuple[bool, List[str]]:
    """(agree, report lines) of the port's output against the JAX doc."""
    doc, port = read_tables(doc_text), read_tables(port_text)
    report, diffs = [], []
    skipped_time, skipped_not_run = set(), set()
    worst = {"bpp": 0.0, "PSNR": 0.0}
    tol = {"bpp": 0.0, "PSNR": psnr_tol}
    paired, cells, j = 0, 0, 0
    unpaired_port = []
    used = set()
    for ti, t in enumerate(port):
        k = j
        while k < len(doc) and doc[k].header != t.header:
            k += 1
        if k == len(doc):
            unpaired_port.append(t)
            continue
        d = doc[k]
        used.add(k)
        j = k + 1
        paired += 1
        where = f"table {ti + 1} (`| {' | '.join(t.header)} |`)"
        if len(t.rows) != len(d.rows):
            diffs.append(f"{where}: {len(t.rows)} rows against the doc's {len(d.rows)}")
        not_run = {c for c in range(len(t.header))
                   if t.rows and all(r[c] == NOT_RUN for r in t.rows if c < len(r))}
        for c in not_run:
            skipped_not_run.add(t.header[c])
        for r, (pr, dr) in enumerate(zip(t.rows, d.rows)):
            if len(pr) != len(dr):
                diffs.append(f"{where} row {r + 1}: {len(pr)} cells against {len(dr)}")
                continue
            for c, name in enumerate(t.header):
                if c in not_run:
                    continue
                if is_time_column(name):
                    skipped_time.add(name)
                    continue
                cells += 1
                kind = ("bpp" if "bpp" in name and "Δ" not in name
                        else "PSNR" if "psnr" in name.lower() and "Δ" not in name
                        else None)
                a, b = _number(pr[c]), _number(dr[c])
                if kind and a is not None and b is not None:
                    delta = abs(a - b)
                    worst[kind] = max(worst[kind], delta)
                    # the slack absorbs the parse of the printed decimals
                    if delta > tol[kind] + 1e-9 * max(1.0, abs(b)):
                        diffs.append(f"{where} row {r + 1} `{name}`: {pr[c]} against "
                                     f"the doc's {dr[c]} (|Δ| {delta:.3g} > {tol[kind]:g})")
                elif pr[c] != dr[c]:
                    diffs.append(f"{where} row {r + 1} `{name}`: {pr[c]} against "
                                 f"the doc's {dr[c]}")
    if paired == 0:
        diffs.append("no table of the port's output has a counterpart in the doc")
    bd_port, bd_doc = bd_rates(port_text), bd_rates(doc_text)
    if bd_port != bd_doc:
        diffs.append(f"BD-rates {bd_port} against the doc's {bd_doc}")
    report.append(f"tables paired: {paired}; cells compared: {cells}; "
                  f"BD-rates compared: {len(bd_port)}")
    if skipped_time:
        report.append("skipped, a machine's times or rates: "
                      + ", ".join(f"`{n}`" for n in sorted(skipped_time)))
    if skipped_not_run:
        report.append("skipped, printed `not run` by the port: "
                      + ", ".join(f"`{n}`" for n in sorted(skipped_not_run)))
    for k, d in enumerate(doc):
        if k not in used:
            report.append(f"doc table without a port counterpart (doc line {d.line}): "
                          f"`| {' | '.join(d.header)} |`")
    for t in unpaired_port:
        report.append(f"port table without a doc counterpart: `| {' | '.join(t.header)} |`")
    report.append(f"max |Δbpp| = {worst['bpp']:.3e}, max |ΔPSNR| = {worst['PSNR']:.3e}")
    report += [f"DIFF: {d}" for d in diffs]
    report.append(f"VERDICT: {'equal' if not diffs else f'{len(diffs)} difference(s)'}")
    return not diffs, report


def against(doc_path: str, port_text: str,
            psnr_tol: float = 0.0) -> Tuple[bool, str]:
    """(agree, markdown section) for a tool's ``--against``: the report
    printed and appended to the tool's output document."""
    with open(doc_path) as f:
        ok, lines = compare(f.read(), port_text, psnr_tol)
    text = "\n".join([f"## Against `{doc_path}`", "",
                      "Compared by `scripts/torch_rd_against.py`"
                      f" (bpp equal as printed, PSNR tolerance {psnr_tol:g}):", "",
                      *(f"- {ln}" for ln in lines), ""])
    print(text)
    return ok, text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("doc", help="the JAX package's RD document")
    ap.add_argument("port", help="the port tool's output document")
    ap.add_argument("--psnr-tol", type=float, default=0.0)
    args = ap.parse_args(argv)
    with open(args.port) as f:
        ok, _ = against(args.doc, f.read(), args.psnr_tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
