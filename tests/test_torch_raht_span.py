"""The port's span RAHT against the JAX package's on padded frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.models.pipeline import prepare_voxel_frame as jax_prepare
from raht3dgs_tpu.ops import raht_span as js
from raht3dgs_tpu_torch.models.pipeline import voxel_frame_from_arrays
from raht3dgs_tpu_torch.ops import raht_span as ts


def _frames(depth, n, bucket, seed=0):
    r = np.random.default_rng(seed)
    pts, _, attrs = unique_voxel_cloud(r, n, depth)
    out = {}
    for jdt in (jnp.float64, jnp.float32):
        jf = jax_prepare(pts, attrs, depth, bucket=bucket, dtype=jdt)
        tf = voxel_frame_from_arrays(
            np.array(jf.codes), np.array(jf.attributes), np.array(jf.weights),
            jf.n_voxels, depth, jf.vmin, jf.width, device="cpu")
        out[jdt] = (jf, tf)
    return out


CASES = [(6, 300, 256), (10, 1500, 1024), (18, 1200, 1024)]


@pytest.mark.parametrize("depth,n,bucket", CASES)
def test_topology_matches_exactly(depth, n, bucket):
    jf, tf = _frames(depth, n, bucket)[jnp.float64]
    drop, prev_ge, next_ge, levels, _ = js._span_topology(jf.codes, depth)
    tdrop, tprev, tnext, tlevels, _ = ts._span_topology(tf.codes, depth)
    assert tlevels == levels
    for a, b in ((tdrop, drop), (tprev, prev_ge), (tnext, next_ge)):
        assert b.dtype == jnp.int32 and a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_msb_matches_including_wide_branch(rng):
    x = rng.integers(1, 2**62, size=5000, dtype=np.int64)
    x[:63] = np.int64(1) << np.arange(63, dtype=np.int64)  # every power
    x[63:126] = x[:63] | (x[:63] - 1)                          # all-ones runs
    want = np.asarray(js._msb(jnp.asarray(x), 63))
    assert np.array_equal(ts._msb(torch.as_tensor(x), 63).numpy(), want)
    y = rng.integers(1, 2**31 - 1, size=5000).astype(np.int32)
    assert np.array_equal(ts._msb(torch.as_tensor(y), 31).numpy(),
                          np.asarray(js._msb(jnp.asarray(y), 31)))


def test_value_propagation_equals_gathers(rng):
    jf, tf = _frames(10, 1500, 1024)[jnp.float64]
    W, _ = ts._weight_prefix(tf.weights, torch.float64)
    drop, prev_ge, next_ge, _, w_prev, w_next, _ = ts._span_topology(tf.codes, 10, W)
    assert torch.equal(w_prev, W[torch.clamp(prev_ge, min=0).long()])
    assert torch.equal(w_next, W[next_ge.long()])


@pytest.mark.parametrize("depth,n,bucket", CASES)
def test_forward_f64_matches(depth, n, bucket):
    jf, tf = _frames(depth, n, bucket)[jnp.float64]
    want = js.raht_forward_span(jf.codes, jf.attributes, jf.weights, depth)
    got = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, depth)
    c = np.asarray(want.coeffs)
    assert np.abs(got.coeffs.numpy() - c).max() <= 1e-12 * np.abs(c).max()
    assert np.array_equal(got.structure.drop_level.numpy(),
                          np.asarray(want.structure.drop_level))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


@pytest.mark.parametrize("depth,n,bucket", CASES)
def test_forward_f32_matches(depth, n, bucket):
    jf, tf = _frames(depth, n, bucket)[jnp.float32]
    want = js.raht_forward_span(jf.codes, jf.attributes, jf.weights, depth)
    got = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, depth)
    c = np.asarray(want.coeffs, np.float64)
    assert got.coeffs.dtype == torch.float32
    assert np.abs(got.coeffs.numpy() - c).max() <= 1e-5 * np.abs(c).max()
    # integer weights: exact under either package's scan association
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-9), (jnp.float32, 1e-2)])
@pytest.mark.parametrize("depth,n,bucket", CASES)
def test_inverse_roundtrip_and_structure(depth, n, bucket, dtype, tol):
    jf, tf = _frames(depth, n, bucket)[dtype]
    fwd = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, depth)
    rec = ts.raht_inverse_span(fwd.coeffs, tf.codes, tf.weights, depth)
    nv = tf.n_voxels
    assert np.abs(rec.numpy()[:nv] - tf.attributes.numpy()[:nv]).max() < tol
    # decoder structure == encoder fused-pack weights, bit for bit
    st = ts.raht_structure_span(tf.codes, tf.weights, depth)
    assert torch.equal(st.node_weights, fwd.weights)
    assert torch.equal(st.drop_level, fwd.structure.drop_level)
    assert torch.equal(st.subtree_w, fwd.structure.subtree_w)
    # and the port's inverse agrees with the JAX inverse on JAX coefficients
    jc = js.raht_forward_span(jf.codes, jf.attributes, jf.weights, depth).coeffs
    want = np.asarray(js.raht_inverse_span(jc, jf.codes, jf.weights, depth))
    got = ts.raht_inverse_span(torch.as_tensor(np.array(jc)), tf.codes,
                               tf.weights, depth).numpy()
    assert np.abs(got - want).max() < (1e-9 if dtype == jnp.float64 else 1e-3)


def test_fractional_weights_structure_bitwise():
    # multiplicity weights that are not integers: the pack's weight column
    # and the standalone scan still agree bit for bit (same association)
    r = np.random.default_rng(3)
    pts, _, attrs = unique_voxel_cloud(r, 900, 8)
    jf = jax_prepare(pts, attrs, 8, bucket=512, dtype=jnp.float32,
                     weights=r.uniform(0.5, 3.0, size=len(pts)))
    tf = voxel_frame_from_arrays(
        np.array(jf.codes), np.array(jf.attributes), np.array(jf.weights),
        jf.n_voxels, 8, jf.vmin, jf.width, device="cpu")
    fwd = ts.raht_forward_span(tf.codes, tf.attributes, tf.weights, 8)
    st = ts.raht_structure_span(tf.codes, tf.weights, 8)
    assert torch.equal(st.node_weights, fwd.weights)


@pytest.mark.parametrize("k", [1, 4])
def test_prefix_pack_f32_equals_cat_construction(rng, k):
    body = torch.from_numpy(rng.uniform(0, 50, size=(3000, k)).astype(np.float32))
    hi, lo = ts._ds_cumsum(body)
    want = torch.cat([torch.zeros(1, 2 * k), torch.cat([hi, lo], dim=1)])
    assert torch.equal(ts._prefix_pack(body, True), want)
    P64 = ts._prefix_pack(body, False)
    assert P64.dtype == torch.float64 and not P64[0].any()
    assert torch.equal(P64[1:], torch.cumsum(body.double(), dim=0))


@pytest.mark.parametrize("k", [1, 4])
def test_prefix_pack_f32_matches_jax_transform(rng, k):
    # the transform's own f32 pack in both packages: a zero row, [hi | lo];
    # the integer (weight-like) lane bit for bit, the others to 1e-12
    body = rng.uniform(0, 50, size=(3000, k)).astype(np.float32)
    body[:, -1] = rng.integers(0, 4, size=3000)
    P = ts._prefix_pack(torch.from_numpy(body), True).numpy()
    J = np.asarray(js._prefix_pack(jnp.asarray(body), True))
    assert P.shape == J.shape == (3001, 2 * k) and not P[0].any()
    assert np.array_equal(P[:, [k - 1, 2 * k - 1]], J[:, [k - 1, 2 * k - 1]])
    got = P[:, :k].astype(np.float64) + P[:, k:]
    want = J[:, :k].astype(np.float64) + J[:, k:]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
