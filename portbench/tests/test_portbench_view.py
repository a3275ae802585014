"""The gs-view cell at a tiny size on the CPU (registered in
``portbench/conftest.py``): the generic cell and control tests'
assertions on it (the result's keys, device keys, positive metrics, JSON;
the bfloat16 control not correct, the float64 one correct), each planted
fault not correct, the orbit's start, and the cell's per-layer metrics
that read the program reading a traced request."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, run
from portbench.kinds import gs_view
from portbench.tests import test_portbench_cells as cells
from portbench.tests import test_portbench_control as controls
from portbench.tests import tiny
from raht3dgs_tpu_torch.eval import rasterize
from raht3dgs_tpu_torch.utils import timing

NAME = "gs-view"
SEED = 2**40 + 11
METRICS = ["serve_decode_ms.view", "render_ms.view", "blend_ms.view", "raster_syncs.view",
           "rlgr_thread_pct.view"]


def test_view_cell_runs_and_agrees():
    cells.test_cell_runs_and_agrees(NAME)


def test_view_control_fails():
    controls.test_control_fails(NAME)


def test_view_float64_control_passes():
    controls.test_float64_control_passes(NAME)


def test_orbit_starts_at_the_nearest_camera():
    """Each scene's requests go round its orbit in the cameras' order from
    the one nearest a Gaussian; the scenes alternate."""
    vms = np.stack([np.eye(4)] * 4)
    for k, z in enumerate([5.0, 3.0, 1.5, 4.0]):
        vms[k, 2, 3] = z  # camera k at (0, 0, -z)
    assert gs_view._orbit(vms, np.zeros((1, 3))).tolist() == [2, 3, 0, 1]
    ctx = harness.Ctx(cell=tiny.cell(NAME), seed=SEED, device=torch.device("cpu"))
    ctx.cell.config = dict(ctx.cfg, views=4)
    state = {"scenes": [{"orbit": np.array([2, 3, 0, 1])}, {"orbit": np.array([1, 2, 3, 0])}]}
    assert [gs_view._pick(ctx, state, i) for i in range(10)] == [
        (0, 2), (1, 1), (0, 3), (1, 2), (0, 0), (1, 3), (0, 1), (1, 0), (0, 2), (1, 1)]


def _reversed_depth_order(monkeypatch):
    """The blend in reversed depth order: the projection's depths negated
    after its near-plane test."""
    real = rasterize.project_gaussians

    def bad(*a, **k):
        out = list(real(*a, **k))
        out[2] = -out[2]
        return tuple(out)

    monkeypatch.setattr(rasterize, "project_gaussians", bad)


def _geometry_shifted(monkeypatch):
    """Positions decoded from the geometry section one voxel off along x."""
    from raht3dgs_tpu_torch.codec import geometry

    real = geometry.positions_from_geometry

    def bad(*a, **k):
        V = real(*a, **k).copy()
        V[:, 0] += 1
        return V

    monkeypatch.setattr(geometry, "positions_from_geometry", bad)


def _stale_image(monkeypatch):
    """A request answered with the previous request's image."""
    from raht3dgs_tpu_torch.models import serving

    real = serving.serve_sequence
    last = {}

    def bad(*a, **k):
        for imgs, dups, tiles in real(*a, **k):
            prev = last.get("imgs")
            last["imgs"] = imgs
            yield (imgs if prev is None else prev), dups, tiles

    monkeypatch.setattr(serving, "serve_sequence", bad)


def _tile_capacity_ignored(monkeypatch):
    """Every tile keeps all its entries, whatever the configured capacity."""
    real = rasterize._rasterize_tiled

    def bad(*a, **k):
        return real(*a, **dict(k, max_per_tile=1 << 20))

    monkeypatch.setattr(rasterize, "_rasterize_tiled", bad)
    from raht3dgs_tpu_torch.parallel import render

    monkeypatch.setattr(render, "_rasterize_tiled", bad)


FAULTS = [_reversed_depth_order, _geometry_shifted, _stale_image]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_view_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    res = run.run(tiny.args(NAME, seconds=0.3), cell=tiny.cell(NAME), device="cpu")
    assert not res["correct"], res["checks"]


def test_clip_count_fault_is_caught(monkeypatch):
    """With a tile capacity that clips at the tiny size, a rasterizer that
    ignores it reports other clip counts."""
    _tile_capacity_ignored(monkeypatch)
    cell = tiny.cell(NAME)
    cell.config = dict(cell.config, max_per_tile=4)
    res = run.run(tiny.args(NAME, seconds=0.3), cell=cell, device="cpu")
    assert not res["correct"] and res["checks"]["clip_diff"]["value"] > 0, res["checks"]


@pytest.fixture
def traced_request():
    """One request of the tiny cell served under a CPU profiler."""
    cell = tiny.cell(NAME)
    ctx = harness.Ctx(cell=cell, seed=SEED, device=torch.device("cpu"))
    ctx.sample = harness.Reservoir(harness.check_rng(SEED), 1)
    state = gs_view.setup(ctx)
    timing.reset()
    yield lambda: gs_view._serve(ctx, state, 0)
    timing.reset()


@pytest.mark.parametrize("name", METRICS)
def test_view_readers(name, traced_request, monkeypatch):
    read = harness.metric_reader(name)
    assert read({}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        traced_request()
    v = read({})
    assert v is not None and np.isfinite(v) and v > 0
    if name == "raster_syncs.view":
        # the occupancy read, the chunks' saturation tests; the image's copy
        # is the consumer's own
        assert v == timing.snapshot()["counts"]["raster_syncs"]
    monkeypatch.delattr(timing, "snapshot")
    assert read({}) is None


def test_view_copy_reader(traced_request, monkeypatch):
    """``copy_mb.view``: None from a CPU request (no bytes cross to a card);
    on a recorded snapshot, the copied bytes over the ``serve`` roots."""
    read = harness.metric_reader("copy_mb.view")
    with profile(activities=[ProfilerActivity.CPU]):
        traced_request()
    assert timing.snapshot()["spans"]["serve"]["roots"] == 1 and read({}) is None
    snap = {"spans": {"serve": {"calls": 4, "roots": 4, "total_s": 2.0, "self_s": 0.1}},
            "counts": {"h2d_bytes_pageable": 150_000_000, "d2h_bytes_pageable": 50_000_000}}
    monkeypatch.setattr(timing, "snapshot", lambda: snap)
    assert read({}) == pytest.approx(50.0)
