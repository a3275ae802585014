"""The port's attribute codec against the JAX package's, end to end.

Symbols must be identical except where the JAX coefficient over the step
lies within 1e-9 (f64) or 1e-5 (f32, relative) of a rounding tie: XLA:CPU
fuses some of the span transform's products into fused multiply-adds
(``-b*x0 + a*x1``), the port does not, so the last bits of a coefficient
may differ and a value sitting on a tie may round the other way. Streams
cross both ways, and the port pins its own stream hashes.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import pipeline as jp
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.utils import synth
from raht3dgs_tpu_torch.utils.synth import unique_voxel_cloud as port_cloud

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
_TIE_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-5}
_REC_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-3}

# the port's own stream hashes of the golden fixture, pinned on the CPU
GOLDEN_F64 = "c64b25eb1c839a4b028184f47c785316747ff1c15e31f3ed3fdcd1cd5239d3ce"
GOLDEN_F32 = "a9b2fe7b64c2f6f57a11a548949226564911a643018b97f05d351f3353b09552"


def _golden_cloud(integer_colours=True):
    r = np.random.default_rng(42)
    pts, _, attrs = unique_voxel_cloud(r, 600, 6)
    if integer_colours:
        attrs = (pts * 7 % 256).astype(np.float64)
    return pts, attrs, 6, 1024, 4.0


def _j10_cloud():
    r = np.random.default_rng(7)
    pts, _, attrs = unique_voxel_cloud(r, 20000, 10)
    return pts, attrs, 10, 8192, 16.0


def _both_frames(pts, attrs, depth, bucket, jdt):
    jf = jp.prepare_voxel_frame(pts, attrs, depth, bucket=bucket, dtype=jdt)
    tf = tp.voxel_frame_from_arrays(
        np.array(jf.codes), np.array(jf.attributes), np.array(jf.weights),
        jf.n_voxels, depth, jf.vmin, jf.width, device="cpu")
    return jf, tf


def _symbols(stream, n):
    out = np.zeros((stream.n_channels, n), np.int32)
    rlgr_decode_channels(stream.channels, n, out=out, chunk=stream.chunk)
    return out


def _tie_mask(jcodec, jf, step, quant_mode, tol):
    """(D, n) mask of stream positions whose JAX coefficient lies on a tie."""
    coeffs, order, _, _ = jcodec.transform(jf)
    n = jf.n_voxels
    perm = np.asarray(jp._pads_last(order, jnp.int32(n)))[:n]
    c = np.asarray(coeffs, np.float64)[perm]
    if quant_mode == "deadzone":
        t = np.abs(c) / step + jcodec.quant_f
    else:
        t = c / step + 0.5
    return (np.abs(t - np.round(t)) <= tol * np.maximum(1.0, np.abs(t))).T


def _check_pair(cloud, jdt, order_mode, quant_mode, chunk=0):
    pts, attrs, depth, bucket, step = cloud
    jf, tf = _both_frames(pts, attrs, depth, bucket, jdt)
    jc = jp.AttributeCodec(depth, dtype=jdt, order_mode=order_mode,
                           quant_mode=quant_mode, chunk=chunk)
    tc = tp.AttributeCodec(depth, dtype=_TORCH[jdt], order_mode=order_mode,
                           quant_mode=quant_mode, chunk=chunk, device="cpu")
    js = jc.encode(jf, step).stream
    ts = tc.encode(tf, step).stream
    n = jf.n_voxels
    a, b = _symbols(js, n), _symbols(ts, n)
    diff = a != b
    if diff.any():
        ties = _tie_mask(jc, jf, step, quant_mode, _TIE_TOL[jdt])
        assert not (diff & ~ties).any(), (
            f"{int((diff & ~ties).sum())} symbols differ away from a tie")
        assert np.abs(a - b)[diff].max() == 1

    # streams cross both ways; same stream -> same reconstruction
    ts_b, js_b = ts.to_bytes(), js.to_bytes()
    for blob in (js_b, ts_b):
        rec_t, _ = tc.decode(FrameStream.from_bytes(blob), tf.codes, tf.weights)
        rec_j, _ = jc.decode(JaxStream.from_bytes(blob), jf.codes, jf.weights)
        assert rec_t.shape == (n, attrs.shape[1])
        assert np.abs(rec_t - np.asarray(rec_j)).max() < _REC_TOL[jdt]
    return js_b, ts_b, diff


@pytest.mark.parametrize("quant_mode", ["mid", "deadzone"])
@pytest.mark.parametrize("order_mode", ["ragft", "weight_desc", "morton"])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_golden_fixture_symbols_and_cross_decode(jdt, order_mode, quant_mode):
    _check_pair(_golden_cloud(), jdt, order_mode, quant_mode)


@pytest.mark.parametrize("order_mode,quant_mode,chunk", [
    ("ragft", "mid", 0), ("weight_desc", "deadzone", 0), ("morton", "mid", 4096)])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_j10_frame_symbols_and_cross_decode(jdt, order_mode, quant_mode, chunk):
    _check_pair(_j10_cloud(), jdt, order_mode, quant_mode, chunk)


@pytest.mark.parametrize("order_mode", ["ragft", "weight_desc"])
@pytest.mark.parametrize("quant_mode", ["mid", "deadzone"])
def test_noninteger_colours_f64_streams_byte_identical(order_mode, quant_mode):
    js_b, ts_b, diff = _check_pair(_golden_cloud(integer_colours=False),
                                   jnp.float64, order_mode, quant_mode)
    assert not diff.any()
    assert js_b == ts_b


@pytest.mark.parametrize("dtype,want", [(torch.float64, GOLDEN_F64),
                                        (torch.float32, GOLDEN_F32)])
def test_port_golden_stream_hash(dtype, want):
    # the fixture of tests/test_pipeline.py::test_stream_format_frozen, built
    # with the port's own numpy helpers (the same seed gives the same cloud);
    # chip_smoke.py reads the same pins from utils/synth.py
    pts, attrs = synth.golden_fixture()
    assert np.array_equal(attrs, _golden_cloud()[1])
    frame = tp.prepare_voxel_frame(pts, attrs, 6, bucket=1024, dtype=dtype,
                                   device="cpu")
    blob = tp.AttributeCodec(6, dtype=dtype, device="cpu").encode(
        frame, steps=4.0).stream.to_bytes()
    assert hashlib.sha256(blob).hexdigest() == want
    assert synth.GOLDEN_SHA256[str(dtype).split(".")[1]] == want


def test_port_cloud_equals_conftest_cloud():
    a = unique_voxel_cloud(np.random.default_rng(5), 300, 7)
    b = port_cloud(np.random.default_rng(5), 300, 7)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_progressive_prefix_matches_jax():
    pts, attrs, depth, bucket, step = _golden_cloud(integer_colours=False)
    jf, tf = _both_frames(pts, attrs, depth, bucket, jnp.float64)
    tc = tp.AttributeCodec(depth, device="cpu")
    blob = tc.encode(tf, step).stream.to_bytes()
    for k in (1, 37, 600):
        rec_t, _ = tc.decode_progressive(FrameStream.from_bytes(blob), tf.codes,
                                         tf.weights, k)
        rec_j, _ = jp.AttributeCodec(depth).decode_progressive(
            JaxStream.from_bytes(blob), jf.codes, jf.weights, k)
        assert np.abs(rec_t - np.asarray(rec_j)).max() < 1e-9


def test_j18_frame_roundtrip_and_symbols():
    r = np.random.default_rng(0)
    pts, _, attrs = unique_voxel_cloud(r, 400, 18)
    cloud = (pts, attrs * 50, 18, 512, 1.0)
    _, ts_b, _ = _check_pair(cloud, jnp.float64, "ragft", "mid")
    frame = tp.prepare_voxel_frame(pts, attrs * 50, 18, bucket=512, device="cpu")
    assert frame.codes.dtype == torch.int64
    rec, _ = tp.AttributeCodec(18, device="cpu").decode(
        FrameStream.from_bytes(ts_b), frame.codes, frame.weights)
    rmse = float(np.sqrt(np.mean((rec - frame.attributes.numpy()[:400]) ** 2)))
    assert rmse <= 0.5


def test_unported_options_raise():
    with pytest.raises(ValueError, match="unknown impl"):
        tp.AttributeCodec(6, device="cpu", impl="bogus")
    with pytest.raises(ValueError):
        tp.AttributeCodec(6, device="cpu", order_mode="bogus")
    codec = tp.AttributeCodec(6, device="cpu")
    frame = tp.prepare_voxel_frame(np.zeros((1, 3), np.int64), np.ones((1, 3)), 6,
                                   device="cpu")
    stream = codec.encode(frame, 1.0).stream
    stream.predict = True  # a predicted-RAHT stream needs the RA-GFT order
    stream.order_mode = "morton"
    with pytest.raises(ValueError, match="RA-GFT"):
        codec.decode(stream, frame.codes, frame.weights)
    # uint64 codes (J=21) round-trip through the flipped int64 form
    from raht3dgs_tpu_torch.ops.morton import codes_to_host

    u = np.array([0, 7, 2**63 - 1, 2**63, 2**63 + 3], np.uint64)
    f = tp.voxel_frame_from_arrays(u, np.zeros((5, 3)), np.ones(5), 3, 21, np.zeros(3),
                                   1.0, device="cpu")
    assert f.codes.dtype == torch.int64 and torch.all(f.codes[1:] > f.codes[:-1])
    np.testing.assert_array_equal(codes_to_host(f.codes, 21), u)
