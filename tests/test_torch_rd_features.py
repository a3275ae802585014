"""The port's six feature RD tools against the JAX package's, on the CPU:
each JAX tool's ``main([... small ..., "--out", a])`` and the port tool's
``main([... small ..., "--device", "cpu", "--out", b, "--against", a])``,
the two documents compared by ``scripts/torch_rd_against.py``: every
table paired, every compared cell equal as printed, the BD-rates equal.

The temporal and rate-control tools code P-frames from the closed loop's
previous reconstruction. XLA:CPU fuses multiply-adds in the transform and
the port does not, so the two packages' reconstructions differ in the last
bits (~1e-13); where whole blocks reconstruct to one value the motion
search's witness errors tie exactly, and those bits break the ties
(ROADMAP, the gate of item 6). So those two run in lockstep
(``tests/torch_lockstep.py``): the port's ``SequenceCodec`` takes the JAX
encoder's reconstruction as its prediction source before each frame, and
the JAX package makes every witness decision of the port's search again.
From the same reconstruction the two make every decision alike (the port
forms the witness error as XLA does, ``ops/temporal.py:_fma``), search the
same motion and code the same streams.
"""

import importlib.util
import os
import sys

import pytest
import torch

import torch_lockstep as lockstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

# the JAX tools' own arguments at a small size
CASES = {
    "deadzone": ["--n", "2000", "--depth", "8", "--steps", "0.5", "2", "8", "32",
                 "--color-steps", "1", "4", "16", "64"],
    "attr_entropy": ["--n", "2000", "--depth", "8", "--color-steps", "1", "8", "64",
                     "--gs-steps", "1", "8", "32"],
    "predict": ["--n", "2000", "--depth", "8", "--steps", "1", "8", "32",
                "--color-steps", "1", "8", "64"],
    "temporal": ["--depth", "6", "--frames", "3", "--samples", "20000",
                 "--steps", "4", "16", "32"],
    "ratecontrol": ["--depth", "6", "--frames", "3", "--budgets", "2", "4"],
    "tiling": ["--n", "3000", "--depth", "8", "--bricks", "1", "2"],
}
TABLES = {"deadzone": 3, "attr_entropy": 3, "predict": 6, "temporal": 1,
          "ratecontrol": 2, "tiling": 2}
LOCKSTEP = {"temporal", "ratecontrol"}


def _load(name: str, path: str):
    for d in (SCRIPTS, REPO):
        if d not in sys.path:
            sys.path.insert(0, d)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CASES))
def test_feature_table_matches_jax(tmp_path, monkeypatch, capsys, name):
    jax_doc, port_doc = tmp_path / "jax.md", tmp_path / "port.md"
    jax_tool = _load(f"rd_{name}", os.path.join(SCRIPTS, f"rd_{name}.py"))
    assert jax_tool.main([*CASES[name], "--out", str(jax_doc)]) == 0
    port_tool = _load(f"torch_rd_{name}", os.path.join(SCRIPTS, f"torch_rd_{name}.py"))
    argv = [*CASES[name], "--device", "cpu", "--out", str(port_doc),
            "--against", str(jax_doc)]
    capsys.readouterr()
    if name in LOCKSTEP:
        from raht3dgs_tpu_torch.models import temporal as ttm

        monkeypatch.setattr(ttm, "SequenceCodec", lockstep.twin_class(follow=True))
        del lockstep.RECORD[:]
        with lockstep.counting() as record:
            rc = port_tool.main(argv)
        total = lockstep.totals(record)
        # the search ran, and from the same reconstruction nothing parted
        assert total["rows"] > 0 and total["max_prev"] == 0.0
        assert (total["flips"], total["mv_rows"], total["frames_streams_differ"]) == (
            0, 0, 0), total
    else:
        rc = port_tool.main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"tables paired: {TABLES[name]};" in out
    assert "VERDICT: equal" in out and "doc table without" not in out
    # the verdict is kept in the port's document
    assert port_doc.read_text().rstrip().endswith("- VERDICT: equal")


@pytest.mark.parametrize("jax_prev, port_prev, flips, ties", [
    ((12.0, 12.0), (12.0, 12.0), 0, 0),
    # a last-bit change breaks the exact tie the other way
    ((12.0 + 1e-12, 12.0), (12.0, 12.0), 1, 1),
    # a real change of the previous reconstruction moves the winner
    ((13.0, 12.5), (12.0, 12.5), 1, 0),
], ids=["same", "tie", "moved"])
def test_witness_flips_counted(jax_prev, port_prev, flips, ties):
    """The twin's witness comparison on a row whose nearest witnesses,
    (4,5,5) and (6,5,5), hold the previous values given: the JAX package
    decides on ``jax_prev``, the port on ``port_prev``."""
    from raht3dgs_tpu_torch.ops.morton import morton_encode

    depth = 4
    prev_V = torch.tensor([[5, 5, 5], [4, 5, 5], [6, 5, 5], [9, 9, 9]])
    prev_codes, order = torch.sort(morton_encode(prev_V, depth))

    def prev(a, b):
        return torch.tensor([[10.0], [a], [b], [50.0]], dtype=torch.float64)[order]

    P = torch.tensor([[5, 5, 5], [9, 9, 9]])
    at = torch.tensor([[12.0], [50.0]], dtype=torch.float64)
    args = (P, at, torch.ones(2, dtype=torch.bool), torch.zeros_like(P), prev_codes,
            prev(*port_prev), torch.ones(4, dtype=torch.bool), (1 << depth) - 1, depth,
            "search")
    rows, n_flip, n_tie, _ = lockstep.compare_witness(args, prev(*jax_prev))
    assert (rows, n_flip, n_tie) == (2, flips, ties)


def test_feature_tools_refuse_silent_cpu(monkeypatch):
    """Without a card and without ``--device cpu`` each tool raises."""
    from raht3dgs_tpu_torch.utils import device as tdev

    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    for name in (*CASES, "parity_check", "parity_3dgs"):
        tool = _load(f"torch_rd_{name}", os.path.join(SCRIPTS, f"torch_rd_{name}.py"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(["--n", "10"] if "parity" in name else [])
