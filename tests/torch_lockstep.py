"""The port's ``SequenceCodec`` beside the JAX package's, frame by frame, with
every motion-search witness decision made by both packages.

``twin_class(follow)`` returns a subclass of the port's
``models/temporal.py:SequenceCodec`` that codes each frame a second time
through the JAX package's ``SequenceCodec`` (its twin), on the same frame
rebuilt by the JAX package. With ``follow`` (lockstep), the port takes the
twin's reconstruction of the frame before as its prediction source before
each frame, so both search against the same previous reconstruction.
Without it (free) each keeps its own closed loop, as the tools run.

Inside ``counting()``, every call of the port's
``ops/temporal.py:_witness_offsets`` made by a twin's motion search is made
again by the JAX package's ``_witness_offsets`` (under ``jax.jit``) on the
same rows, with the twin's previous reconstruction in place of the port's.
``RECORD`` gets one entry a frame:

- ``rows``: witness decisions (valid rows, over the search's iterations);
- ``flips``: decisions whose winning probe differs between the packages;
- ``tie_flips``: flips whose two winners' errors, as the port computes
  them, lie within ``TIE_REL`` (relative) of each other;
- ``mv_rows``: rows whose searched motion vector differs between the two
  packages' ``search_block_motion``;
- ``max_prev``: the largest |Δ| between the two previous reconstructions;
- ``kinds``, ``steps``, ``stream_equal``, ``symbols``: each package's frame
  kind and step, whether the two chosen streams are equal byte for byte,
  and how many decoded symbols differ when they are not.

Run as a script it holds a port sequence tool against the JAX tool at
the configurations given (the JAX tool's document, then the port tool on
the CPU with a twin in each mode, ``--against`` that document), prints a
JSON line of counts a mode and configuration, and writes the report
``DIR/twin_rd_<tool>.md``; ``--doc`` also holds the JAX tool's output
against the package's committed document:

    JAX_PLATFORMS=cpu python tests/torch_lockstep.py temporal --out-dir DIR \\
        --doc docs/rd_temporal.md -- --depth 9 --frames 10 -- --depth 8 --frames 8
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TIE_REL = 1e-9
# previous reconstructions this close count as the same up to last bits
NEAR = 1e-9
RECORD: list = []
# (twin, JAX previous reconstruction as a tensor, the frame's entry) while
# a twin's port search runs
_ACTIVE = None


def _shell_index(woff: torch.Tensor) -> torch.Tensor:
    """The position in ``_SHELL27`` of each witness offset."""
    from raht3dgs_tpu_torch.ops.temporal import _SHELL27

    w = woff.to(torch.int64) + 1
    key = torch.tensor([(x + 1) * 9 + (y + 1) * 3 + (z + 1) for x, y, z in _SHELL27])
    pos = torch.empty(27, dtype=torch.int64)
    pos[key] = torch.arange(27)
    return pos[w[:, 0] * 9 + w[:, 1] * 3 + w[:, 2]]


def _port_errors(P_rows, at_rows, mv_rows, codes_prev, attrs_prev, occ_p, lim, depth, join):
    """The port's (N, 27) witness errors, as ``_witness_offsets`` forms them."""
    from raht3dgs_tpu_torch.ops import temporal as tt

    cp = tt._probe_codes(P_rows - mv_rows, tt._SHELL27, lim, depth, codes_prev.dtype)
    hit, idx = tt._probe_match(cp, codes_prev, occ_p, join)
    d = attrs_prev[idx].to(torch.float64) - at_rows[:, None, :]
    sq = d * d
    err = sq[..., 0]
    for c in range(1, sq.shape[2]):
        err = err + sq[..., c]
    return torch.where(hit, err, torch.full_like(err, float("inf")))


@functools.lru_cache(maxsize=None)
def _jax_witness():
    import jax

    from raht3dgs_tpu.ops import temporal as jt

    return jax.jit(jt._witness_offsets, static_argnames=("lim", "depth", "join"))


def compare_witness(args, jax_prev):
    """(rows, flips, tie_flips, port outputs) of one ``_witness_offsets``
    call ``args``, the JAX package deciding on ``jax_prev`` in place of the
    port's previous reconstruction."""
    import jax.numpy as jnp

    from raht3dgs_tpu_torch.ops import temporal as tt

    (P_rows, at_rows, occ_rows, mv_rows, codes_prev, attrs_prev, occ_p, lim, depth,
     join) = args
    woff, valid = (_ORIGINAL or tt._witness_offsets)(*args)
    assert jax_prev.shape == attrs_prev.shape, (jax_prev.shape, attrs_prev.shape)
    jw = _jax_witness()
    jwoff, jvalid = jw(jnp.asarray(P_rows.numpy().astype(np.int32)),
                       jnp.asarray(at_rows.numpy()), jnp.asarray(occ_rows.numpy()),
                       jnp.asarray(mv_rows.numpy().astype(np.int32)),
                       jnp.asarray(codes_prev.numpy()), jnp.asarray(jax_prev.numpy()),
                       jnp.asarray(occ_p.numpy()), lim=int(lim), depth=int(depth),
                       join=join)
    jwoff, jvalid = torch.as_tensor(np.array(jwoff)), torch.as_tensor(np.array(jvalid))
    assert torch.equal(jvalid, valid), "the packages' probe hits differ"
    flip = valid & (jwoff != woff).any(1)
    n_flip = int(flip.sum())
    n_tie = 0
    if n_flip:
        err = _port_errors(P_rows, at_rows, mv_rows, codes_prev, attrs_prev, occ_p,
                           lim, depth, join)[flip]
        r = torch.arange(err.shape[0])
        a = err[r, _shell_index(woff[flip])]
        b = err[r, _shell_index(jwoff[flip])]
        n_tie = int(((a - b).abs() <= TIE_REL * a.abs().clamp_min(1.0)).sum())
    return int(valid.sum()), n_flip, n_tie, (woff, valid)


def _counted_witness(*args):
    if _ACTIVE is None:
        return _ORIGINAL(*args)
    _, jax_prev, entry = _ACTIVE
    rows, flips, ties, out = compare_witness(args, jax_prev)
    entry["rows"] += rows
    entry["flips"] += flips
    entry["tie_flips"] += ties
    return out


_ORIGINAL = None


@contextlib.contextmanager
def counting():
    """Count witness flips and compare motion fields while twins code."""
    global _ORIGINAL
    from raht3dgs_tpu.models import temporal as jtm
    from raht3dgs_tpu_torch.models import temporal as ttm
    from raht3dgs_tpu_torch.ops import temporal as tt

    saved = (tt._witness_offsets, ttm.search_block_motion, jtm.search_block_motion)
    _ORIGINAL = saved[0]

    def port_search(*a, **k):
        mv = saved[1](*a, **k)
        if _ACTIVE is not None:
            _ACTIVE[2]["_port_mv"] = mv
        return mv

    def jax_search(*a, **k):
        mv = saved[2](*a, **k)
        _LAST_JAX["mv"] = mv
        return mv

    tt._witness_offsets, ttm.search_block_motion, jtm.search_block_motion = (
        _counted_witness, port_search, jax_search)
    try:
        yield RECORD
    finally:
        tt._witness_offsets, ttm.search_block_motion, jtm.search_block_motion = saved
        _ORIGINAL = None


_LAST_JAX: dict = {}


def _symbols_apart(a, b) -> int:
    """Decoded symbols that differ between two streams' channels (-1 when
    their layouts differ)."""
    from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels

    if (a.n_voxels != b.n_voxels or len(a.channels) != len(b.channels)
            or getattr(a, "chunk", 0) != getattr(b, "chunk", 0)
            or getattr(a, "rac", None) or getattr(b, "rac", None)):
        return -1
    va, _ = rlgr_decode_channels(list(a.channels), a.n_voxels, chunk=a.chunk)
    vb, _ = rlgr_decode_channels(list(b.channels), b.n_voxels, chunk=getattr(b, "chunk", 0))
    return int(np.sum(va[:, : a.n_voxels] != vb[:, : b.n_voxels]))


def twin_class(follow: bool = True):
    """The port's ``SequenceCodec`` with a JAX twin (module docstring)."""
    from raht3dgs_tpu.models import temporal as jtm
    from raht3dgs_tpu.models.pipeline import prepare_voxel_frame as jax_frame
    from raht3dgs_tpu_torch.models import temporal as ttm
    from raht3dgs_tpu_torch.ops.morton import morton_decode

    class Twin(ttm.SequenceCodec):
        def __init__(self, depth, **kw):
            self._twin = jtm.SequenceCodec(depth, **{k: v for k, v in kw.items()
                                                     if k != "device"})
            self._jax_frames = {}
            self._entry = None
            super().__init__(depth, **kw)

        def reset(self):
            super().reset()
            self._twin.reset()

        def _jax(self, frame):
            key = id(frame)
            if key not in self._jax_frames:
                n = frame.n_voxels
                V = morton_decode(frame.codes[:n], self.depth).numpy().astype(np.int64)
                self._jax_frames[key] = (frame, jax_frame(
                    V, frame.attributes[:n].numpy(), self.depth,
                    bucket=frame.codes.shape[0]))
            return self._jax_frames[key][1]

        def _begin(self):
            """Before a frame: the twin's previous reconstruction, taken by
            the port in lockstep; a new entry of ``RECORD``."""
            jprev = None
            if self._twin._prev is not None:
                jprev = torch.as_tensor(np.array(self._twin._prev[1]))
                if follow:
                    self._prev = (self._prev[0], jprev)
            max_prev = (float((jprev - self._prev[1].cpu()).abs().max())
                        if jprev is not None and self._prev is not None else 0.0)
            self._entry = {"index": self._index, "rows": 0, "flips": 0, "tie_flips": 0,
                           "mv_rows": 0, "max_prev": max_prev}
            _LAST_JAX.clear()
            return jprev

        def _end(self, jres, pres):
            e = self._entry
            js, ps = jres[0], pres[0]
            e["kinds"] = ("P" if ps.inter else "I") + ("P" if js.inter else "I")
            if len(jres) > 2:
                e["steps"] = [float(pres[2]), float(jres[2])]
            e["stream_equal"] = (list(ps.channels) == list(js.channels)
                                 and bool(ps.inter) == bool(js.inter))
            e["symbols"] = 0 if e["stream_equal"] else _symbols_apart(ps, js)
            pmv, jmv = e.pop("_port_mv", None), _LAST_JAX.get("mv")
            if pmv is not None and jmv is not None:
                jmv = torch.as_tensor(np.array(jmv))
                n = min(pmv.shape[0], jmv.shape[0])
                e["mv_rows"] = int((pmv[:n].cpu() != jmv[:n]).any(1).sum())
            RECORD.append(e)
            self._entry = None

        def _search(self, frame, prev):
            global _ACTIVE
            _ACTIVE = (self, self._jprev, self._entry)
            try:
                return super()._search(frame, prev)
            finally:
                _ACTIVE = None

        def encode_frame(self, frame, steps, timer=None):
            self._jprev = self._begin()
            jres = self._twin.encode_frame(self._jax(frame), steps)
            pres = super().encode_frame(frame, steps, timer=timer)
            self._end(jres, pres)
            return pres

        def encode_frame_target(self, frame, target_bpp, *args, **kw):
            self._jprev = self._begin()
            jres = self._twin.encode_frame_target(self._jax(frame), target_bpp)
            pres = super().encode_frame_target(frame, target_bpp, *args, **kw)
            self._end(jres, pres)
            return pres

    return Twin


def totals(record) -> dict:
    """The record summed over its frames."""
    out = {"frames": len(record)}
    for k in ("rows", "flips", "tie_flips", "mv_rows"):
        out[k] = sum(e[k] for e in record)
    out["max_prev"] = max((e["max_prev"] for e in record), default=0.0)
    out["frames_streams_differ"] = sum(not e["stream_equal"] for e in record)
    out["symbols"] = sum(max(e["symbols"], 0) for e in record)
    out["kinds_differ"] = sum(e["kinds"][0] != e["kinds"][1] for e in record)
    # the searches made from reconstructions still within NEAR of each other
    near = [e for e in record if e["rows"] and e["max_prev"] < NEAR]
    out["near_searches"] = len(near)
    for k in ("rows", "flips", "tie_flips"):
        out[f"near_{k}"] = sum(e[k] for e in near)
    out["near_max_prev"] = max((e["max_prev"] for e in near), default=0.0)
    return out


def load_tool(name: str):
    """A tool of ``scripts/``, imported by path as its siblings import it."""
    for d in (SCRIPTS, REPO):
        if d not in sys.path:
            sys.path.insert(0, d)
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _tool_runs(tool, configs, out, extra=(), against=None):
    """``tool``'s ``main`` once a configuration, the later ones appended to
    ``out`` (the temporal document holds two), ``--against`` on the last.
    Returns (exit code, RECORD length after each configuration)."""
    mod = load_tool(tool)
    rc, marks = 0, []
    for i, argv in enumerate(configs):
        last = i == len(configs) - 1
        rc = mod.main([*argv, *extra, "--out", out, *(["--append"] if i else []),
                       *(["--against", against] if against and last else [])]) or rc
        marks.append(len(RECORD))
    return rc, marks


def run(tool: str, configs, out_dir: str, modes=("lockstep", "free"), doc=None) -> list:
    """The JAX tool's document at ``configs`` (each an argument list), then
    the port tool on the CPU with a twin in each mode, ``--against`` that
    document. Returns one result a (mode, configuration) and writes
    ``twin_rd_<tool>.md`` (the report) and ``.json`` (every frame)."""
    for d in (REPO, SCRIPTS):
        if d not in sys.path:
            sys.path.insert(0, d)
    os.makedirs(out_dir, exist_ok=True)
    # the tools run inside out_dir, so the report names its files alone
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        return _run(tool, configs, modes, doc, doc and os.path.join(cwd, doc))
    finally:
        os.chdir(cwd)


def _run(tool, configs, modes, doc, doc_path):
    from raht3dgs_tpu_torch.models import temporal as ttm

    from torch_rd_against import compare

    jax_doc = f"jax_rd_{tool}.md"
    rc, _ = _tool_runs(f"rd_{tool}", configs, jax_doc)
    assert rc == 0
    results, frames, sections = [], {}, []
    for mode in modes:
        port_doc = f"port_rd_{tool}_{mode}.md"
        saved = ttm.SequenceCodec
        ttm.SequenceCodec = twin_class(mode == "lockstep")
        del RECORD[:]
        try:
            with counting():
                rc, marks = _tool_runs(f"torch_rd_{tool}", configs, port_doc,
                                       ("--device", "cpu"), against=jax_doc)
        finally:
            ttm.SequenceCodec = saved
        frames[mode] = list(RECORD)
        for argv, lo, hi in zip(configs, [0, *marks[:-1]], marks):
            results.append({"tool": tool, "mode": mode, "argv": list(argv),
                            "against_rc": rc, **totals(RECORD[lo:hi])})
        with open(port_doc) as f:
            text = f.read()
        sections += [f"### The port in {mode}", "",
                     text[text.index("## Against"):].replace("## Against", "Against", 1)]
    with open(f"twin_rd_{tool}.json", "w") as f:
        json.dump({"results": results, "frames": frames}, f, indent=1)
    keys = ("rows", "flips", "tie_flips", "mv_rows", "max_prev", "frames",
            "frames_streams_differ", "symbols", "kinds_differ")
    lines = [f"# rd_{tool}: the port beside the JAX package, frame by frame", "",
             "`tests/torch_lockstep.py` on the CPU: the JAX package's "
             f"`scripts/rd_{tool}.py` at each configuration below, then the port's "
             f"`scripts/torch_rd_{tool}.py` with a JAX twin coding every frame beside "
             "it, in lockstep (the port predicts from the twin's previous "
             "reconstruction) and free (each keeps its own closed loop, as the tools "
             "run), `--against` the JAX tool's document. 'rows': the witness "
             "decisions of the port's motion search; 'flips': those the JAX "
             "package, deciding on the same rows with its own previous "
             "reconstruction, makes otherwise; 'tie flips': of them, those whose "
             f"two winners' errors lie within {TIE_REL:g} (relative); 'mv rows': "
             "rows whose searched motion differs; 'max |Δprev|': the largest "
             "difference of the two previous reconstructions; 'frames apart': "
             "frames whose chosen streams differ, with their differing symbols "
             "and frame kinds.", "",
             "| mode | configuration | " + " | ".join(
                 ("rows", "flips", "tie flips", "mv rows", "max \\|Δprev\\|", "frames",
                  "frames apart", "symbols apart", "kinds apart")) + " | document against the JAX tool's |",
             "|---|---|" + "---|" * len(keys) + "---|"]
    for r in results:
        cells = [f"{r[k]:.3g}" if k == "max_prev" else str(r[k]) for k in keys]
        lines.append(f"| {r['mode']} | `{' '.join(r['argv'])}` | " + " | ".join(cells)
                     + f" | {'equal' if r['against_rc'] == 0 else 'differs'} |")
    lines += ["", f"The searches made from previous reconstructions within {NEAR:g} "
              "of each other (every search in lockstep; free-running, those "
              "before the two closed loops part):", "",
              "| mode | configuration | searches | rows | flips | tie flips "
              "| max \\|Δprev\\| |", "|---|---|---|---|---|---|---|"]
    for r in results:
        lines.append(f"| {r['mode']} | `{' '.join(r['argv'])}` | {r['near_searches']} "
                     f"| {r['near_rows']} | {r['near_flips']} | {r['near_tie_flips']} "
                     f"| {r['near_max_prev']:.3g} |")
    lines += ["", *sections]
    if doc:
        with open(jax_doc) as f:
            ok, report = compare(open(doc_path).read(), f.read())
        lines += [f"### The JAX tool today against `{doc}`", "",
                  *(f"- {ln}" for ln in report), ""]
    with open(jax_doc) as f:
        lines += ["### The JAX tool today", "",
                  *(f"###{ln}" if ln.startswith("#") else ln
                    for ln in f.read().strip().splitlines()), ""]
    with open(f"twin_rd_{tool}.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("tool", choices=("temporal", "ratecontrol"))
    ap.add_argument("--modes", nargs="+", choices=("lockstep", "free"),
                    default=["lockstep", "free"])
    ap.add_argument("--doc", default=None,
                    help="the JAX package's committed document, held against "
                    "the JAX tool's output today")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--threads", type=int, default=4)
    argv = list(sys.argv[1:] if argv is None else argv)
    cuts = [i for i, a in enumerate(argv) if a == "--"] + [len(argv)]
    args = ap.parse_args(argv[:cuts[0]])
    configs = [argv[a + 1:b] for a, b in zip(cuts[:-1], cuts[1:])] or [[]]
    torch.set_num_threads(args.threads)
    for r in run(args.tool, configs, args.out_dir, args.modes, args.doc):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
