"""The port's R3TC container reads every version the JAX package writes
and writes the same bytes for the same fields."""

import dataclasses

import numpy as np
import pytest

from raht3dgs_tpu.codec import bitstream as jb
from raht3dgs_tpu_torch.codec import bitstream as tb

_BASE = dict(depth=10, n_voxels=1234, steps=np.array([4.0]),
             channels=[b"\x01\x02", b"", b"\xff" * 9],
             vmin=np.array([1.0, -2.0, 0.5]), width=3.25)

CASES = {
    "v2_plain": {},
    "v2_chunked_deadzone_f32": dict(chunk=4096, quant_mode="deadzone", quant_f=0.3,
                                    rec_delta=0.12, dtype32=True,
                                    order_mode="weight_desc"),
    "v2_per_channel_steps": dict(steps=np.array([1.0, 2.0, 3.0]), order_mode="morton"),
    "v2_inter_derived": dict(inter=True, probes=27),
    "v3_inter_motion": dict(inter=True, motion=b"motion-bytes"),
    "v4_geometry": dict(geometry=b"geom" * 5),
    "v4_inter_geometry": dict(geometry=b"g", inter=True),
    "v5_entropy_map": dict(entropy_map=(True, False, True)),
    "v5_predict": dict(predict=True, predict_mask=0b1011),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_container_bytes_match(name):
    fields = {**_BASE, **CASES[name]}
    blob = jb.FrameStream(**fields).to_bytes()
    assert tb.FrameStream(**fields).to_bytes() == blob
    parsed = tb.FrameStream.from_bytes(blob)
    want = jb.FrameStream.from_bytes(blob)
    for f in dataclasses.fields(jb.FrameStream):
        a, b = getattr(parsed, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert parsed.to_bytes() == blob


def test_version_1_stream_parses():
    blob = bytearray(jb.FrameStream(**_BASE).to_bytes())
    blob[4] = 1  # v1 shares the v2 layout with flag bits 4-7 unset
    assert tb.FrameStream.from_bytes(bytes(blob)).channels == _BASE["channels"]


def test_corrupt_streams_raise():
    blob = tb.FrameStream(**_BASE).to_bytes()
    for bad in (blob[:10], b"XXXX" + blob[4:], blob[:-1]):
        with pytest.raises(ValueError):
            tb.FrameStream.from_bytes(bad)
