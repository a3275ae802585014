"""The port's batched codec against the JAX package's and against its own
single-frame codec: the scan kernel's batched entry (plain version on the
CPU), the batched span transform, ``parallel/sharding.py`` and
``models/batch_codec.py``.

Tolerances: the batched forms equal the port's single-frame functions on
every frame bit for bit (same operations in the same order). Against the
JAX package, coefficients agree to 1e-12 (f64) / 1e-5 (f32) of the largest
(as in ``tests/test_torch_raht_span.py``), orders exactly, and symbols
under the gate of ROADMAP queue A item 6: equal except where the JAX
coefficient over the step lies within 1e-9 (f64) / 1e-5 (f32) of a
rounding tie; streams decode across both packages, reconstructions within
1e-9 (f64) / 1e-3 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.codec.bitstream import FrameStream as JaxStream
from raht3dgs_tpu.models import batch_codec as jbc
from raht3dgs_tpu.ops.pallas_scan import ds_cumsum_pallas
from raht3dgs_tpu.parallel import sharding as js
from raht3dgs_tpu_torch.codec.bitstream import FrameStream
from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode_channels
from raht3dgs_tpu_torch.models import batch_codec as tbc
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import ds_scan
from raht3dgs_tpu_torch.ops import raht_span as ts
from raht3dgs_tpu_torch.parallel import sharding as tsh

_TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}
_COEFF_TOL = {jnp.float64: 1e-12, jnp.float32: 1e-5}
_TIE_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-5}
_REC_TOL = {jnp.float64: 1e-9, jnp.float32: 1e-3}
DEPTH = 5
SIZES = (300, 450, 200, 380)


def _cloud(rng, sizes=SIZES, d_attr=3):
    pos, attrs = [], []
    for n in sizes:
        p, _, a = unique_voxel_cloud(rng, n, DEPTH, d_attr=d_attr)
        pos.append(p.astype(np.int64))
        attrs.append(a)
    return pos, attrs


def _both_batches(rng, jdt, d_attr=3, sizes=SIZES):
    """The same frames through both packages' ``prepare_frame_batch``."""
    pos, attrs = _cloud(rng, sizes, d_attr)
    jf = jbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=jdt)
    tf = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=_TORCH[jdt],
                                 device="cpu")
    for a, b in zip(jf, tf):
        assert a.n_voxels == b.n_voxels
        np.testing.assert_array_equal(b.codes.numpy(), np.asarray(a.codes))
        np.testing.assert_array_equal(b.attributes.numpy(), np.asarray(a.attributes))
        np.testing.assert_array_equal(b.weights.numpy(), np.asarray(a.weights))
    return jf, tf


def _stacks(frames, xp):
    return tuple(xp.stack([getattr(f, k) for f in frames])
                 for k in ("codes", "attributes", "weights"))


# -- the scan kernel's batched entry -------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 9])
def test_batched_scan_plain_equals_per_frame(rng, k):
    # unequal real counts: each frame's rows past its count are padding zeros
    x = rng.normal(scale=50, size=(3, 3000, k)).astype(np.float32)
    for b, n in enumerate((3000, 2100, 17)):
        x[b, n:] = 0.0
    xt = torch.from_numpy(x)
    hi, lo = ds_scan.ds_cumsum_batched(xt)
    P = ds_scan.ds_prefix_pack_batched(xt)
    assert hi.shape == lo.shape == (3, 3000, k) and P.shape == (3, 3001, 2 * k)
    for b in range(3):
        rh, rl = ds_scan.ds_cumsum_reference(xt[b])
        assert torch.equal(hi[b], rh) and torch.equal(lo[b], rl)
        assert torch.equal(P[b], ds_scan.ds_prefix_pack_reference(xt[b]))
    # the JAX package's Pallas kernel under vmap, as its batched codec runs it
    ph, pl = jax.vmap(lambda a: ds_cumsum_pallas(a, interpret=True))(jnp.asarray(x))
    got = hi.double().numpy() + lo.double().numpy()
    want = np.asarray(ph, np.float64) + np.asarray(pl, np.float64)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_batched_scan_cpu_takes_plain_path(rng, monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(ds_scan.KERNEL, "load", no_kernel)
    before = dict(ds_scan.LAUNCHES)
    x = torch.from_numpy(rng.uniform(0, 3, size=(2, 300, 4)).astype(np.float32))
    ds_scan.ds_prefix_pack_batched(x)
    ds_scan.ds_cumsum_batched(x)
    assert ds_scan.LAUNCHES == before
    assert ds_scan.ds_prefix_pack_batched(torch.zeros(2, 0, 3)).shape == (2, 1, 6)


def test_batched_scan_rejects_bad_input():
    with pytest.raises(TypeError):
        ds_scan.ds_cumsum_batched(torch.zeros(2, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(B, N, K\)"):
        ds_scan.ds_prefix_pack_batched(torch.zeros(4, 2))
    with pytest.raises(ValueError, match="column"):
        ds_scan._launch_batched(torch.zeros(2, 4, 0), pack=True)
    with pytest.raises(ValueError, match="contiguous"):
        ds_scan._launch_batched(torch.zeros(2, 4, 6)[:, :, :2], pack=False)
    with pytest.raises(ValueError, match="CUDA"):
        ds_scan._launch_batched(torch.zeros(2, 4, 2), pack=True)


@pytest.mark.cuda
def test_cuda_batched_scan_equals_single_entry(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for b, n, k in ((3, 70000, 4), (2, 5000, 1), (2, 2049, 9)):
        x = torch.from_numpy(rng.uniform(0, 3, size=(b, n, k)).astype(np.float32)).cuda()
        before = ds_scan.LAUNCHES["ds_cumsum_batched"]
        P = ds_scan.ds_prefix_pack_batched(x)
        hi, lo = ds_scan.ds_cumsum_batched(x)
        torch.cuda.synchronize()
        assert ds_scan.LAUNCHES["ds_cumsum_batched"] == before + 2
        ref = ds_scan.ds_prefix_pack_batched_reference(x)
        got = P[:, 1:, :k].double() + P[:, 1:, k:].double()
        want = ref[:, 1:, :k].double() + ref[:, 1:, k:].double()
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        for f in range(b):
            assert torch.equal(P[f], ds_scan.ds_prefix_pack(x[f].contiguous()))
            h1, l1 = ds_scan.ds_cumsum(x[f].contiguous())
            assert torch.equal(hi[f], h1) and torch.equal(lo[f], l1)


# -- the batched span transform against the port's single-frame one ----------


@pytest.mark.parametrize("d_attr", [3, 8])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_batched_transform_equals_single_frame(rng, jdt, d_attr):
    _, frames = _both_batches(rng, jdt, d_attr)
    codes, attrs, weights = _stacks(frames, torch)
    fb = ts.raht_forward_span_batched(codes, attrs, weights, DEPTH)
    sb = ts.raht_structure_span_batched(codes, weights, DEPTH)
    ib = ts.raht_inverse_span_batched(fb.coeffs, codes, weights, DEPTH)
    for i, f in enumerate(frames):
        fs = ts.raht_forward_span(f.codes, f.attributes, f.weights, DEPTH)
        assert torch.equal(fb.coeffs[i], fs.coeffs)
        assert torch.equal(fb.weights[i], fs.weights)
        for a, b in zip(fb.structure, fs.structure):
            assert torch.equal(a[i], b)
        for a, b in zip(sb, ts.raht_structure_span(f.codes, f.weights, DEPTH)):
            assert torch.equal(a[i], b)
        assert torch.equal(ib[i], ts.raht_inverse_span(fs.coeffs, f.codes, f.weights, DEPTH))


def test_batched_transform_fractional_weights_bitwise(rng):
    # weights that are not integers: the decoder's structure pass still
    # matches the forward's node weights, frame by frame
    _, frames = _both_batches(rng, jnp.float32, sizes=(200, 150))
    codes, attrs, _ = _stacks(frames, torch)
    weights = torch.from_numpy(rng.uniform(0.5, 3.0, size=codes.shape).astype(np.float32))
    weights[0, 200:] = 0.0
    weights[1, 150:] = 0.0
    fb = ts.raht_forward_span_batched(codes, attrs, weights, DEPTH)
    sb = ts.raht_structure_span_batched(codes, weights, DEPTH)
    assert torch.equal(sb.node_weights, fb.weights)
    for i in range(2):
        fs = ts.raht_forward_span(codes[i], attrs[i], weights[i], DEPTH)
        assert torch.equal(fb.coeffs[i], fs.coeffs)


# -- parallel/sharding.py against the JAX package --------------------------


def _tie_gate(j_sym, t_sym, j_coeffs_T, steps, nvox, tol):
    """Symbols (B, D, N) equal but where the JAX coefficient is on a tie."""
    for b, n in enumerate(nvox):
        a, c = np.asarray(j_sym)[b, :, :n], t_sym[b, :, :n]
        diff = a != c
        if diff.any():
            t = np.asarray(j_coeffs_T, np.float64)[b, :, :n] / steps + 0.5
            ties = np.abs(t - np.round(t)) <= tol * np.maximum(1.0, np.abs(t))
            assert not (diff & ~ties).any(), "symbols differ away from a tie"
            assert np.abs(a - c)[diff].max() == 1


@pytest.mark.parametrize("d_attr", [3, 8])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_sharding_functions_match_jax(rng, jdt, d_attr):
    jf, tf = _both_batches(rng, jdt, d_attr)
    jc, ja, jw = _stacks(jf, jnp)
    tc, ta, tw = _stacks(tf, torch)
    nvox = [f.n_voxels for f in jf]
    jn, tn = jnp.asarray(nvox, jnp.int32), torch.tensor(nvox, dtype=torch.int32)
    step = 4.0
    jcoef, jorder = js.batched_forward(jc, ja, jw, DEPTH, "ragft", jn)
    tcoef, torder = tsh.batched_forward(tc, ta, tw, DEPTH, "ragft", tn)
    c = np.asarray(jcoef)
    assert np.abs(tcoef.numpy() - c).max() <= _COEFF_TOL[jdt] * np.abs(c).max()
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    assert torder.dtype == torch.int32

    steps_j = jnp.atleast_1d(jnp.asarray(step, dtype=jdt))
    steps_t = torch.tensor([step], dtype=_TORCH[jdt])
    j_sym = js.batched_quant_reorder(jcoef, steps_j, jorder)
    j_coeffs_T = js.batched_reorder_T(jcoef, jorder)
    t_T = tsh.batched_reorder_T(tcoef, torder)
    assert t_T.shape == (len(nvox), d_attr, 512)
    t_sym = tsh.batched_quant_T(t_T, steps_t)
    assert torch.equal(t_sym, tsh.batched_quant_reorder(tcoef, steps_t, torder))
    assert torch.equal(t_sym, tsh.batched_transform_step(tc, ta, tw, steps_t, DEPTH,
                                                         nvox=tn))
    _tie_gate(j_sym, t_sym.numpy(), j_coeffs_T, step, nvox, _TIE_TOL[jdt])

    jinv = js.batched_inverse_order(jc, jw, jn, DEPTH)
    tinv = tsh.batched_inverse_order(tc, tw, tn, DEPTH)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    # the same symbols decode alike in both packages
    j_rec = js.batched_decode_step(jc, jw, j_sym, jinv, jnp.asarray(step, jdt), DEPTH, jdt)
    t_rec = tsh.batched_decode_step(tc, tw, torch.from_numpy(np.array(j_sym)), tinv,
                                    torch.tensor(step, dtype=_TORCH[jdt]), DEPTH,
                                    _TORCH[jdt])
    assert np.abs(t_rec.numpy() - np.asarray(j_rec)).max() < _REC_TOL[jdt]
    j_mse = float(js.batched_roundtrip_step(jc, ja, jw, jnp.asarray(step, jdt), DEPTH))
    t_mse = float(tsh.batched_roundtrip_step(tc, ta, tw, torch.tensor(step, dtype=_TORCH[jdt]),
                                             DEPTH))
    assert abs(t_mse - j_mse) <= 1e-3 * j_mse


@pytest.mark.parametrize("quant_mode", ["mid", "deadzone"])
@pytest.mark.parametrize("order_mode", ["weight_desc", "morton"])
def test_sharding_orders_and_deadzone_match_jax(rng, order_mode, quant_mode):
    jf, tf = _both_batches(rng, jnp.float64)
    jc, ja, jw = _stacks(jf, jnp)
    tc, ta, tw = _stacks(tf, torch)
    nvox = [f.n_voxels for f in jf]
    jn, tn = jnp.asarray(nvox, jnp.int32), torch.tensor(nvox, dtype=torch.int32)
    jcoef, jorder = js.batched_forward(jc, ja, jw, DEPTH, order_mode, jn)
    tcoef, torder = tsh.batched_forward(tc, ta, tw, DEPTH, order_mode, tn)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tsh.batched_inverse_order(tc, tw, tn, DEPTH, order_mode).numpy(),
                                  np.asarray(js.batched_inverse_order(jc, jw, jn, DEPTH,
                                                                      order_mode)))
    qf = 0.3
    j_sym = js.batched_quant_reorder(jcoef, jnp.asarray([2.0]), jorder, quant_mode,
                                     jnp.asarray(qf))
    t_sym = tsh.batched_quant_reorder(tcoef, torch.tensor([2.0], dtype=torch.float64),
                                      torder, quant_mode, torch.tensor(qf, dtype=torch.float64))
    np.testing.assert_array_equal(t_sym.numpy(), np.asarray(j_sym))


def test_mesh_functions_name_their_item():
    for call in (lambda: tsh.make_mesh(4), lambda: tsh.shard_batch(None, 0, 0, 0),
                 lambda: tsh.batched_transform_step_tp(None, 0, 0, 0, 1.0, 5)):
        with pytest.raises(NotImplementedError, match="item 18"):
            call()


# -- BatchAttributeCodec ------------------------------------------------------


@pytest.mark.parametrize("d_attr", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_codec_bytes_equal_per_frame_encode(rng, dtype, d_attr):
    pos, attrs = _cloud(rng, d_attr=d_attr)
    frames = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=dtype, device="cpu")
    bc = tbc.BatchAttributeCodec(DEPTH, dtype=dtype, device="cpu")
    single = tp.AttributeCodec(DEPTH, dtype=dtype, device="cpu")
    streams, timer = bc.encode(frames, steps=4.0)
    assert set(timer.stages) == {"RAHT_transform_time", "Quant_time", "Entropy_enc_time"}
    for f, s in zip(frames, streams):
        assert s.to_bytes() == single.encode(f, steps=4.0).stream.to_bytes()
    recs, _ = bc.decode(streams, frames)
    for f, s, rec in zip(frames, streams, recs):
        ref, _ = single.decode(s, f.codes, f.weights)
        np.testing.assert_array_equal(rec, ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batch_codec_sweep_equals_per_step_encode(rng, dtype):
    steps = [1.0, 4.0, 16.0]
    pos, attrs = _cloud(rng, SIZES[:3])
    frames = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=dtype, device="cpu")
    bc = tbc.BatchAttributeCodec(DEPTH, dtype=dtype, chunk=64, device="cpu")
    coeffs, orderp, _ = bc.transform(frames)
    sweep = bc.encode_sweep(frames, steps, coeffs=coeffs, orderp=orderp)
    assert len(sweep) == len(steps) and bc.encode_sweep(frames, []) == []
    inv = bc.inverse_order(frames)
    single = tp.AttributeCodec(DEPTH, dtype=dtype, chunk=64, device="cpu")
    for s, (streams, timer) in zip(steps, sweep):
        ref_streams, _ = bc.encode(frames, steps=s, coeffs=coeffs, orderp=orderp)
        for f, got, ref in zip(frames, streams, ref_streams):
            assert got.to_bytes() == ref.to_bytes() == single.encode(f, s).stream.to_bytes()
        assert timer.stages["Entropy_enc_time"] > 0
        recs, t2 = bc.decode(streams, frames, inv=inv)
        assert t2.stages["Coeff_reorder_dec_time"] == 0.0
        for a, b in zip(recs, bc.decode(ref_streams, frames)[0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk", [0, 64])
@pytest.mark.parametrize("entropy", ["rac", "auto"])
def test_batch_codec_entropy_matches_per_frame_and_jax(rng, entropy, chunk):
    jf, tf = _both_batches(rng, jnp.float64)
    tcodec = tbc.BatchAttributeCodec(DEPTH, entropy=entropy, chunk=chunk, device="cpu")
    single = tp.AttributeCodec(DEPTH, entropy=entropy, chunk=chunk, device="cpu")
    steps = [4.0, 16.0]
    sweep = tcodec.encode_sweep(tf, steps)
    for s, (streams, _) in zip(steps, sweep):
        for f, got in zip(tf, streams):
            if entropy == "rac":  # auto may keep RLGR on every channel
                assert got.entropy_map == (True,) * 3
            assert got.to_bytes() == single.encode(f, s).stream.to_bytes()
    # uniform non-integer attributes in float64: the JAX batch codec's bytes
    jstreams, _ = jbc.BatchAttributeCodec(DEPTH, entropy=entropy, chunk=chunk).encode(
        jf, steps=steps[0])
    assert [s.to_bytes() for s in sweep[0][0]] == [s.to_bytes() for s in jstreams]
    recs, _ = tcodec.decode(sweep[0][0], tf)
    for f, st, rec in zip(tf, sweep[0][0], recs):
        np.testing.assert_array_equal(rec, single.decode(st, f.codes, f.weights)[0])


def _symbols(stream, n):
    out = np.zeros((stream.n_channels, n), np.int32)
    rlgr_decode_channels(stream.channels, n, out=out, chunk=stream.chunk)
    return out


@pytest.mark.parametrize("d_attr", [3, 8])
@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_batch_codec_matches_jax_batch_codec(rng, jdt, d_attr):
    jf, tf = _both_batches(rng, jdt, d_attr)
    jcodec = jbc.BatchAttributeCodec(DEPTH, dtype=jdt)
    tcodec = tbc.BatchAttributeCodec(DEPTH, dtype=_TORCH[jdt], device="cpu")
    step = 4.0
    jstreams, _ = jcodec.encode(jf, steps=step)
    tstreams, _ = tcodec.encode(tf, steps=step)
    jcoef, jorder, _ = jcodec.transform(jf)
    j_coeffs_T = js.batched_reorder_T(jcoef, jorder)
    nvox = [f.n_voxels for f in jf]
    if jdt == jnp.float64:  # uniform, non-integer attributes: no ties
        assert [s.to_bytes() for s in tstreams] == [s.to_bytes() for s in jstreams]
    else:
        j_sym = np.stack([np.pad(_symbols(s, s.n_voxels), ((0, 0), (0, 512 - s.n_voxels)))
                          for s in jstreams])
        t_sym = np.stack([np.pad(_symbols(s, s.n_voxels), ((0, 0), (0, 512 - s.n_voxels)))
                          for s in tstreams])
        _tie_gate(j_sym, t_sym, j_coeffs_T, step, nvox, _TIE_TOL[jdt])
    # streams decode across both packages, both ways
    for blobs in ([s.to_bytes() for s in jstreams], [s.to_bytes() for s in tstreams]):
        rec_t, _ = tcodec.decode([FrameStream.from_bytes(b) for b in blobs], tf)
        rec_j, _ = jcodec.decode([JaxStream.from_bytes(b) for b in blobs], jf)
        for a, b, n in zip(rec_t, rec_j, nvox):
            assert a.shape == (n, d_attr)
            assert np.abs(a - np.asarray(b)).max() < _REC_TOL[jdt]


def test_batch_codec_refuses_unported_and_mixed(rng):
    for kw, item in ((dict(mesh=object()), 18), (dict(predict=True), 13)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tbc.BatchAttributeCodec(DEPTH, device="cpu", **kw)
    with pytest.raises(ValueError):
        tbc.BatchAttributeCodec(DEPTH, quant_mode="bogus", device="cpu")
    pos, attrs = _cloud(rng, (100, 120))
    frames = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=128, device="cpu")
    bc = tbc.BatchAttributeCodec(DEPTH, device="cpu")
    streams, _ = bc.encode(frames, 2.0)
    other, _ = bc.encode(frames, 3.0)
    with pytest.raises(ValueError, match="homogeneous steps"):
        bc.decode([streams[0], other[1]], frames)
    streams[1].inter = True
    with pytest.raises(ValueError, match="inter"):
        bc.decode(streams, frames)
    streams[1].inter = False
    streams[1].predict = True
    with pytest.raises(ValueError, match="homogeneous transform"):
        bc.decode(streams, frames)
    streams[0].predict = True
    with pytest.raises(NotImplementedError, match="item 13"):
        bc.decode(streams, frames)
    # frames of two padded sizes do not stack
    lone = tp.prepare_voxel_frame(pos[0], attrs[0], DEPTH, bucket=256, device="cpu")
    with pytest.raises(ValueError, match="padded size"):
        bc.transform([frames[0], lone])
    with pytest.raises(ValueError, match="empty"):
        bc.transform([])


def test_shared_bucket_matches_jax(rng):
    pos, attrs = _cloud(rng, (100, 50))
    j = jbc.prepare_frame_batch(pos, attrs, 4, bucket=64)
    t = tbc.prepare_frame_batch(pos, attrs, 4, bucket=64, device="cpu")
    assert [f.codes.shape[0] for f in t] == [f.codes.shape[0] for f in j] == [128, 128]
