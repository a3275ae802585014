"""The port's RLGR coder: byte-identical streams to the JAX package's."""

import filecmp
import os

import numpy as np
import pytest

from raht3dgs_tpu.codec import rlgr as jr
from raht3dgs_tpu_torch.codec import _rlgr_py
from raht3dgs_tpu_torch.codec import rlgr as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _patterns(rng):
    return [
        np.array([], np.int32),
        np.array([5], np.int32),
        np.array([-3, 0, 0, 0, 7, 0, 0, -1], np.int32),
        np.zeros(1000, np.int32),                                  # one zero run
        np.array([0] * 500 + [2**30] + [0] * 500, np.int32),       # GR escape
        np.tile(np.array([1, -1], np.int32), 2000),
        np.array([2**i - 1 for i in range(31)] * 3, np.int32),
        np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, -1], np.int32),       # trailing flush
        (rng.standard_normal(7) * 1e9).astype(np.int32),
        rng.integers(-10, 10, size=2000).astype(np.int32),
        ((rng.geometric(0.05, size=3000) - 1) * rng.choice([-1, 1], 3000)).astype(np.int32),
    ]


@pytest.mark.parametrize("name", ["rlgr.cpp", "rac.cpp", "geom.cpp", "range_coder.h"])
def test_native_source_is_byte_identical_copy(name):
    assert filecmp.cmp(os.path.join(REPO, "raht3dgs_tpu_torch", "native", name),
                       os.path.join(REPO, "raht3dgs_tpu", "native", name),
                       shallow=False)


def test_library_builds_into_port_build_dir():
    lib = tr.NATIVE.load()
    assert lib is not None
    assert os.path.dirname(tr.NATIVE.lib_path).endswith(
        os.path.join("raht3dgs_tpu_torch", "_build"))


@pytest.mark.parametrize("signed", [True, False])
def test_sequential_streams_match(rng, signed):
    for v in _patterns(rng):
        if not signed:
            v = np.abs(v.astype(np.int64)).astype(np.int32)
        got, _ = tr.rlgr_encode(v, signed)
        want, _ = jr.rlgr_encode(v, signed)
        assert got == want
        assert got == _rlgr_py.encode(v.astype(np.int64).tolist(), signed=signed)
        dec, _ = tr.rlgr_decode(got, len(v), signed, out=np.empty(len(v), np.int32))
        assert np.array_equal(dec, v)
        dec64, _ = tr.rlgr_decode(got, len(v), signed)
        assert np.array_equal(dec64, v)


@pytest.mark.parametrize("chunk", [0, 1000])
def test_channel_streams_match_batch_and_per_stream(rng, chunk):
    pats = [p for p in _patterns(rng) if len(p) >= 1000]
    n = min(len(p) for p in pats)
    q = np.ascontiguousarray(np.stack([p[:n] for p in pats]))
    want, _ = jr.rlgr_encode_channels(q, channel_major=True, chunk=chunk, n=n - 7)
    got, _ = tr.rlgr_encode_channels(q, channel_major=True, chunk=chunk, n=n - 7)
    assert got == want
    # the per-stream composition (non-int32 input) writes the same bytes
    per, _ = tr.rlgr_encode_channels(q.astype(np.int64), channel_major=True,
                                     chunk=chunk, n=n - 7)
    assert per == want
    out = np.zeros_like(q)
    tr.rlgr_decode_channels(got, n - 7, out=out, chunk=chunk)
    assert np.array_equal(out[:, :n - 7], q[:, :n - 7])
    assert not out[:, n - 7:].any()
    out64 = np.zeros(q.shape, np.int64)
    tr.rlgr_decode_channels(got, n - 7, out=out64, chunk=chunk)
    assert np.array_equal(out64, out)


def test_chunked_stream_matches(rng):
    v = (rng.standard_normal(5000) * 20).astype(np.int32)
    got, _ = tr.rlgr_encode_chunked(v, chunk=777)
    want, _ = jr.rlgr_encode_chunked(v, chunk=777)
    assert got == want
    dec, _ = tr.rlgr_decode_chunked(got, len(v))
    assert np.array_equal(dec, v)


def test_truncated_chunked_stream_raises(rng):
    v = rng.integers(-50, 50, size=3000).astype(np.int32)
    blob, _ = tr.rlgr_encode_chunked(v, chunk=1000)
    with pytest.raises(ValueError):
        tr.rlgr_decode_chunked(blob[:5], len(v))
    with pytest.raises(ValueError):
        tr.rlgr_decode_chunked(blob[:-3], len(v))
    with pytest.raises(ValueError):
        tr.rlgr_decode_chunked(blob, 5000)
