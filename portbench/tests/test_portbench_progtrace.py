"""The metric files that read the program's own spans and counters
(``portbench/progtrace.py`` over ``timing.snapshot()``): a finite value
over units run under a profiler, None before any, and None from a
program that has no ``snapshot``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from raht3dgs_tpu_torch.models.color_codec import y_psnr_db
from raht3dgs_tpu_torch.models.pipeline import AttributeCodec, prepare_voxel_frame
from raht3dgs_tpu_torch.utils import synth, timing

DEPTH = 6


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _traced_colour():
    """A frame prepared, swept at two steps, decoded and scored, under a
    CPU profiler."""
    pts, _, attrs = synth.unique_voxel_cloud(np.random.default_rng(1), 500, DEPTH, 3)
    codec = AttributeCodec(DEPTH, dtype=torch.float32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        f = prepare_voxel_frame(pts, attrs, DEPTH, bucket=64, dtype=torch.float32,
                                device="cpu")
        encs = codec.encode_sweep(f, [1.0, 4.0])
        rec, _ = codec.decode(encs[0].stream, f.codes, f.weights)
        y_psnr_db(attrs[:, 0], rec[:, 0])


@pytest.mark.parametrize("name", ["prep_span_ms.sweep", "psnr_ms.sweep",
                                  "rlgr_thread_pct.sweep", "rlgr_thread_pct.playback"])
def test_program_readers(name, monkeypatch):
    read = harness.metric_reader(name)
    assert read({}) is None
    _traced_colour()
    v = read({})
    assert v is not None and np.isfinite(v) and v > 0
    if name.startswith("rlgr_thread_pct"):
        assert v <= 100.0
    monkeypatch.delattr(timing, "snapshot")
    assert read({}) is None


@pytest.mark.parametrize("name", ["merge_span_ms.sweep", "copy_mb_per_mvox.sweep",
                                  "copy_mb.playback"])
def test_program_readers_without_their_spans(name):
    """What a CPU run of these units lacks (a merge, bytes to a card) reads
    None rather than 0 or a fault."""
    _traced_colour()
    assert harness.metric_reader(name)({}) is None
