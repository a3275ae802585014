"""The port's validation tools against the JAX package's, on the CPU:
``scripts/torch_check_morton.py`` against ``scripts/check_morton.py``,
``scripts/torch_compare_mat.py`` against ``scripts/compare_mat.py`` (the
same printed lines and exit codes), ``morton_codes_np`` of both preludes
bitwise, and ``examples/end_to_end_torch.py --device cpu`` against
``examples/end_to_end.py`` line by line (``compare_lines``: integers, bpp,
bytes, masks and cell counts equal as printed; PSNRs and RMSEs within the
example's ``PSNR_TOL`` of 0.011 dB, a little over one unit of the printed
0.01) and against the pinned CPU lines that ``chip_smoke.py`` phase 17
holds the card to."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel: str):
    name = "_t_" + os.path.splitext(rel)[0].replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    """Small frames: one intra-op thread is faster on the CPU and leaves the
    other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


# -- check_morton -------------------------------------------------------------

def _morton_ply(path, shuffle: bool, comment: bool):
    from raht3dgs_tpu_torch.io.ply import save_ply_ascii
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np

    rng = np.random.default_rng(3)
    V = np.unique(rng.integers(0, 64, size=(3000, 3)), axis=0) + 5
    V = V[np.argsort(morton_codes_np(V - V.min(0), 6), kind="stable")]
    if shuffle:
        V = V[rng.permutation(len(V))]
    save_ply_ascii(path, V.astype(np.float64), np.full((len(V), 3), 128),
                   width=63 if comment else None)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("extra", [[], ["--depth", "7"]], ids=["header", "depth"])
@pytest.mark.parametrize("comment", [True, False], ids=["width", "range"])
def test_check_morton_matches_jax(tmp_path, capsys, shuffle, extra, comment):
    path = str(tmp_path / "f.ply")
    _morton_ply(path, shuffle, comment)
    jax_tool, port_tool = _load("scripts/check_morton.py"), _load("scripts/torch_check_morton.py")
    jrc, jout = _run(jax_tool.main, [path, *extra], capsys)
    trc, tout = _run(port_tool.main, [path, *extra], capsys)
    assert (trc, tout) == (jrc, jout)
    assert trc == (1 if shuffle else 0)
    assert ("NOT Morton-ordered." in tout) == shuffle


# -- compare_mat --------------------------------------------------------------

def _mats(tmp_path, case):
    import scipy.io as sio

    rng = np.random.default_rng(4)
    a = {"x": rng.normal(size=(5, 4)), "n": np.arange(6).reshape(2, 3)}
    b = {k: v.copy() for k, v in a.items()}
    if case == "differ":
        b["x"][2, 1] += 1e-3
        b["only_b"] = np.ones(2)
    elif case == "cell":
        cell = np.empty((3, 1), dtype=object)
        for i in range(3):
            cell[i, 0] = rng.normal(size=(i + 1, 2))
        a["c"] = cell
        cell2 = np.empty((3, 1), dtype=object)
        for i in range(3):
            cell2[i, 0] = cell[i, 0] + (1e-6 if i == 2 else 0.0)
        b["c"] = cell2
    elif case == "string":
        a["s"] = "RAHT_param"
        b["s"] = "RAHT_param"
        a["t"] = "level"
        b["t"] = "lever"
    elif case == "nan":
        a["x"][0, 0] = np.nan
        b["x"][0, 0] = np.nan
    elif case == "disjoint":
        b = {"y": np.ones(3)}
    pa, pb = str(tmp_path / "a.mat"), str(tmp_path / "b.mat")
    sio.savemat(pa, a)
    sio.savemat(pb, b)
    return pa, pb


@pytest.mark.parametrize("case, rc", [("equal", 0), ("differ", 1), ("cell", 1),
                                      ("string", 1), ("nan", 0), ("disjoint", 1)])
@pytest.mark.parametrize("tol", [[], ["--rtol", "1e-3", "--atol", "1e-5"]],
                         ids=["default", "loose"])
def test_compare_mat_matches_jax(tmp_path, capsys, case, rc, tol):
    pa, pb = _mats(tmp_path, case)
    jax_tool, port_tool = _load("scripts/compare_mat.py"), _load("scripts/torch_compare_mat.py")
    jrc, jout = _run(jax_tool.main, [pa, pb, *tol], capsys)
    trc, tout = _run(port_tool.main, [pa, pb, *tol], capsys)
    assert (trc, tout) == (jrc, jout)
    if not tol or case in ("equal", "nan", "disjoint", "string"):
        assert trc == rc


# -- morton_codes_np ------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 6, 10, 18, 21])
def test_prelude_morton_codes_np_bitwise(depth):
    from raht3dgs_tpu.ops.prelude import morton_codes_np as jax_codes
    from raht3dgs_tpu_torch.ops.prelude import morton_codes_np as port_codes

    rng = np.random.default_rng(depth)
    V = rng.integers(0, 2**depth, size=(5000, 3))
    a, b = jax_codes(V, depth), port_codes(V, depth)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the end-to-end walkthrough ------------------------------------------------------

def _example_lines(jax_side: bool):
    """One walkthrough's printed lines (run in this process)."""
    import contextlib
    import io

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        if jax_side:
            import jax

            update = jax.config.update
            # the suite keeps no persistent compilation cache (tests/conftest.py)
            mp.setattr(jax.config, "update",
                       lambda k, v: None if "cache" in k else update(k, v))
            mp.setattr(sys, "argv", ["end_to_end.py"])
            rc = _load("examples/end_to_end.py").main()
        else:
            rc = _load("examples/end_to_end_torch.py").main(["--device", "cpu"])
    assert rc == 0
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def example_runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {side: _example_lines(side == "jax") for side in ("port", "jax")}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_example_runs_to_its_end(example_runs, side):
    assert len(example_runs[side]) == 14
    assert example_runs[side][-1] == "done."


def test_example_matches_jax_line_by_line(example_runs):
    ex = _load("examples/end_to_end_torch.py")
    assert ex.compare_lines(example_runs["port"], example_runs["jax"]) == []


def test_example_matches_pinned_cpu_lines(example_runs):
    """The pinned lines ``chip_smoke.py`` phase 17 holds the card to are
    this machine's CPU lines, exactly."""
    ex = _load("examples/end_to_end_torch.py")
    assert example_runs["port"] == ex.PINNED.read_text().splitlines()
    assert ex.compare_lines(example_runs["port"], ex.PINNED.read_text().splitlines(), 0.0) == []


@pytest.mark.parametrize("edit, n_diffs", [
    (lambda ls: ls, 0),
    (lambda ls: [ls[0].replace("52650", "52651")] + ls[1:], 1),         # a count
    (lambda ls: [ls[0], ls[1].replace("49.50", "49.51")] + ls[2:], 0),  # a PSNR in tol
    (lambda ls: [ls[0], ls[1].replace("49.50", "49.53")] + ls[2:], 1),  # beyond it
    (lambda ls: [ls[0], ls[1].replace("2.281", "2.282")] + ls[2:], 1),  # a bpp
    (lambda ls: ls[:-1], 1),                                            # a lost line
    (lambda ls: [ls[0].replace("voxels", "points")] + ls[1:], 1),       # the words
])
def test_compare_lines_rules(edit, n_diffs):
    ex = _load("examples/end_to_end_torch.py")
    want = ex.PINNED.read_text().splitlines()
    assert len(ex.compare_lines(edit(list(want)), want)) == n_diffs


def test_example_refuses_silent_cpu(monkeypatch):
    from raht3dgs_tpu_torch.utils import device as tdev

    monkeypatch.setattr(tdev, "cuda_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("examples/end_to_end_torch.py").main([])
