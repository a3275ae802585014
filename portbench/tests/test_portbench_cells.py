"""Each cell's unit runs at a tiny size on the CPU through the whole run
(set-up, window, per-layer readers, the reference's check), agrees with
the reference there, and prints only the contract's keys."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", tiny.cells())
def test_cell_runs_and_agrees(name):
    cell = tiny.cell(name)
    res = run.run(tiny.args(name), cell=cell, device="cpu")
    assert list(res) == KEYS
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.limits)
    json.dumps(res)


@pytest.mark.parametrize("name", tiny.cells())
def test_cell_traced_readers(name):
    """Without a card the profiler's metrics find nothing and are left out;
    the program's and the benchmark's spans are read."""
    cell = tiny.cell(name)
    res = run.run(tiny.args(name, trace=1), cell=cell, device="cpu")
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names
    device_only = {n for n in names if n.startswith(("ds_scan_roofline", "device_idle_pct"))}
    assert set(res["metrics"]) == names - device_only
    assert "breakdown" not in res and list(res)[-1] == "checks"


def test_no_card_no_result():
    """Without a CUDA card the harness exits non-zero and prints nothing."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", tiny.cells()[0],
                           "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_card():
    """On the card: the smallest cell end to end at tiny sizes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "colour-playback"
    res = run.run(tiny.args(name), cell=tiny.cell(name), device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
