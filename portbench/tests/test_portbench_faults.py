"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped (a tiny cell on the CPU) and
each fault a cell can have is planted in the program's module for the
length of the run. One card: there is no exchange between chips to
leave out."""

import numpy as np
import pytest

from portbench import run
from portbench.tests import tiny


def _alter_symbol(monkeypatch):
    """A symbol altered where it is produced, before the entropy coder."""
    from raht3dgs_tpu_torch.models import batch_codec, pipeline

    real = pipeline.build_entropy_stream

    def bad(q_np, *a, **k):
        q = np.array(q_np)
        q[0, 1] += 3
        return real(q, *a, **k)

    monkeypatch.setattr(pipeline, "build_entropy_stream", bad)
    monkeypatch.setattr(batch_codec, "build_entropy_stream", bad)


def _floor_quantizer(monkeypatch):
    """A quantizer that truncates, ``floor(c / step)``, in place of the
    configuration's ``floor(c / step + 0.5)``: every stream, decode and
    PSNR stays consistent with its own symbols."""
    import torch

    from raht3dgs_tpu_torch.models import pipeline

    monkeypatch.setattr(pipeline, "quantize",
                        lambda x, step: torch.floor(x / step).to(torch.int32))


def _quantizer_off_by_one(monkeypatch):
    """A quantizer one step off on every coefficient."""
    from raht3dgs_tpu_torch.models import pipeline

    real = pipeline.quantize
    monkeypatch.setattr(pipeline, "quantize", lambda x, step: real(x, step) + 1)


def _stale_symbols(monkeypatch):
    """A step that returns its state unchanged: every step after a frame's
    first codes the first step's symbols under its own step."""
    from raht3dgs_tpu_torch.models import batch_codec, pipeline

    real = pipeline.build_entropy_stream
    first = {}

    def bad(q_np, frame, steps, **k):
        q = first.setdefault((id(frame), q_np.shape), np.array(q_np))
        return real(q, frame, steps, **k)

    monkeypatch.setattr(pipeline, "build_entropy_stream", bad)
    monkeypatch.setattr(batch_codec, "build_entropy_stream", bad)


def _alter_reconstruction(monkeypatch):
    """A decoded attribute altered where the decoder produces it."""
    from raht3dgs_tpu_torch.models import batch_codec, pipeline

    real_b = batch_codec.BatchAttributeCodec.decode
    real_s = pipeline.AttributeCodec.decode

    def bad_b(self, *a, **k):
        recs, timer = real_b(self, *a, **k)
        for r in recs:
            r[r.shape[0] // 2, 0] += 0.5
        return recs, timer

    def bad_s(self, *a, **k):
        rec, timer = real_s(self, *a, **k)
        rec[rec.shape[0] // 2, 0] += 0.5
        return rec, timer

    monkeypatch.setattr(batch_codec.BatchAttributeCodec, "decode", bad_b)
    monkeypatch.setattr(pipeline.AttributeCodec, "decode", bad_s)


def _half_batch(monkeypatch):
    """Half of the batch left out: the first half's streams and
    reconstructions stand in for the rest."""
    from raht3dgs_tpu_torch.models import batch_codec

    real_s = batch_codec.BatchAttributeCodec.encode_sweep

    def bad_s(self, frames, *a, **k):
        h = len(frames) // 2
        out = real_s(self, frames[:h], *a, **k)
        return [(streams + streams[:len(frames) - h], t) for streams, t in out]

    real_t = batch_codec.BatchAttributeCodec.transform

    def bad_t(self, frames, *a, **k):
        return real_t(self, frames[:len(frames) // 2] * 2, *a, **k)

    monkeypatch.setattr(batch_codec.BatchAttributeCodec, "encode_sweep", bad_s)
    monkeypatch.setattr(batch_codec.BatchAttributeCodec, "transform", bad_t)


def _stale_decode(monkeypatch):
    """A decode that returns its state unchanged: the last frame's
    reconstruction again."""
    from raht3dgs_tpu_torch.models import pipeline

    real = pipeline.AttributeCodec.decode
    last = {}

    def bad(self, *a, **k):
        rec, timer = real(self, *a, **k)
        prev = last.get("rec")
        last["rec"] = rec
        return (rec if prev is None else prev.copy()), timer

    monkeypatch.setattr(pipeline.AttributeCodec, "decode", bad)


def _merge_misplaced(monkeypatch):
    """A Gaussian's voxel altered where the voxelizer produces it."""
    import torch

    from raht3dgs_tpu_torch.models import gs_voxelize

    real = gs_voxelize.voxelize_merge

    def bad(*a, **k):
        out = list(real(*a, **k))
        cl = out[-1].clone()
        cl[0] = (cl[0] + 1) % torch.clamp(out[6], min=2)
        out[-1] = cl
        return tuple(out)

    monkeypatch.setattr(gs_voxelize, "voxelize_merge", bad)


QUANTIZER = [_floor_quantizer, _quantizer_off_by_one]
FAULTS = {
    "colour-rd-sweep-b4": [_alter_symbol, _stale_symbols, _alter_reconstruction, _half_batch]
    + QUANTIZER,
    "colour-playback": [_alter_reconstruction, _stale_decode] + QUANTIZER,
    "gs-rd-sweep": [_alter_symbol, _stale_symbols, _merge_misplaced, _alter_reconstruction]
    + QUANTIZER,
}
CASES = [(c, f) for c in tiny.cells() for f in FAULTS[c]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run.run(tiny.args(name, seconds=0.3), cell=tiny.cell(name), device="cpu")
    assert not res["correct"], res["checks"]
