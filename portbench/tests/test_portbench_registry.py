"""The harness finds every cell, configuration, mix, kind, limit and metric
by name from its files, and BENCHMARK.json keeps to the contract's form."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    cell = harness.find_cell(name)
    assert NAME.match(name) and cell.workload["chips"] in (1, 4)
    assert set(cell.workload) == {"name", "config", "traffic", "chips", "why"}
    assert 1 <= len(cell.workload["why"]) <= 200
    kind = cell.kind()
    for fn in ("setup", "unit", "release", "check", "control", "control_sample"):
        assert callable(getattr(kind, fn))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    reported = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/configs/")
    with open(os.path.join(harness.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"]
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if m["name"] != "setup_s":
        assert callable(harness.metric_reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_reader_falls_back_to_base_name():
    """A metric split by cells without a file of its own is read by the
    file of the name before the first '.'."""
    record = {"profile": {"busy_s": 1.0, "window_s": 4.0}}
    assert harness.metric_reader("device_idle_pct.view")(record) == 75.0
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.view")
