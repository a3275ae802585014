"""The port's scatter-free segment sums against the JAX package's.

Both packages get the same numpy input. Integer outputs (starts, segment
counts, integer-valued lanes) must match exactly under both methods. The
shift method's float lanes are bitwise the JAX package's: the doubling
passes run in the same order over the same padded buffer. The prefix
method's float lanes differ in association (the JAX package's blocked
XLA scan against the port's double-single scan), so they are held to a
tolerance: 1e-12 of the largest |sum| at float64, 1e-5 at float32.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.ops import segment as jseg
from raht3dgs_tpu_torch.ops import ds_scan, segment as tseg

METHODS = ["shift", "prefix"]
_PREFIX_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _random_runs(rng, n, max_run):
    first = np.zeros(n, bool)
    first[0] = True
    i = 0
    while i < n:
        i += int(rng.integers(1, max_run + 1))
        if i < n:
            first[i] = True
    return first


def _both(values, first, method, extra=None):
    j = jseg.sorted_segment_sums(
        jnp.asarray(values), jnp.asarray(first),
        None if extra is None else jnp.asarray(extra), method=method)
    t = tseg.sorted_segment_sums(
        torch.from_numpy(values), torch.from_numpy(first),
        None if extra is None else torch.from_numpy(extra), method=method)
    return j, t


def _np_segment_sums(values, first):
    seg = np.cumsum(first) - 1
    out = np.zeros(values.shape)
    for s in range(seg[-1] + 1):
        out[s] = values[seg == s].astype(np.float64).sum(axis=0)
    return out, seg[-1] + 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_run", [1, 4, 37])
@pytest.mark.parametrize("method", METHODS)
def test_float_lanes_match_jax(rng, method, max_run, dtype):
    n = 1000
    first = _random_runs(rng, n, max_run)
    values = rng.uniform(-100, 100, (n, 5)).astype(dtype)
    (js, jex, jst, jn), (ts, tex, tst, tn) = _both(values, first, method)
    assert jex is None and tex is None
    assert int(tn) == int(jn) and tn.dtype == torch.int32
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert ts.dtype == torch.from_numpy(values).dtype
    ns = int(tn)
    assert not ts[ns:].any()
    if method == "shift":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        err = np.abs(ts.numpy().astype(np.float64) - np.asarray(js, np.float64)).max()
        assert err <= _PREFIX_TOL[dtype] * np.abs(np.asarray(js)).max()
    ref, _ = _np_segment_sums(values, first)
    np.testing.assert_allclose(ts.numpy()[:ns], ref[:ns], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", METHODS)
def test_integer_lanes_exact(rng, method, dtype):
    n = 2048
    first = _random_runs(rng, n, 9)
    values = rng.integers(-1000, 1000, (n, 3)).astype(dtype)
    (js, _, _, _), (ts, _, _, tn) = _both(values, first, method)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ref, ns = _np_segment_sums(values, first)
    np.testing.assert_array_equal(ts.numpy()[:ns], ref[:ns])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fused", [True, False])
def test_extras_sampled_at_starts(rng, method, fused):
    n = 512
    first = _random_runs(rng, n, 5)
    values = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    if fused:
        extra = rng.integers(0, 1 << 20, (n, 2)).astype(np.float32)
    else:  # beyond float32's exact range: must take its own exact gather
        extra = rng.integers(0, 1 << 40, (n, 2)).astype(np.float64)
    (_, jex, _, _), (_, tex, tst, tn) = _both(values, first, method, extra)
    ns = int(tn)
    assert tex.dtype == torch.from_numpy(extra).dtype
    np.testing.assert_array_equal(tex.numpy()[:ns], extra[tst.numpy()[:ns]])
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jex))


@pytest.mark.parametrize("method", METHODS)
def test_degenerate_runs(rng, method):
    n = 257
    v = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    one = np.zeros(n, bool)
    one[0] = True                   # one run of N rows: the most passes
    singles = np.ones(n, bool)      # N runs of one row: no pass at all
    for first, n_seg in ((one, 1), (singles, n)):
        (js, _, jst, _), (ts, _, tst, tn) = _both(v, first, method)
        assert int(tn) == n_seg
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        if method == "shift" or n_seg == n:
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.allclose(ts.numpy()[0], v[first.cumsum() == 1].astype(np.float64).sum(0),
                           rtol=1e-5, atol=1e-4)
        assert not ts[n_seg:].any()


def test_wide_f32_prefix_goes_in_column_blocks(rng):
    # the kernel takes at most MAX_K columns; a wider pack is scanned in
    # column blocks, bitwise the one-piece scan (columns are independent)
    x = torch.from_numpy(rng.uniform(0, 5, (3000, ds_scan.MAX_K + 3)).astype(np.float32))
    assert torch.equal(tseg._ds_prefix(x), ds_scan.ds_prefix_pack_reference(x))


def test_segment_starts_matches_jax(rng):
    first = _random_runs(rng, 700, 6)
    js, jn = jseg.segment_starts(jnp.asarray(first))
    ts, tn = tseg.segment_starts(torch.from_numpy(first))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn) == int(jn) and ts.dtype == torch.int32


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        tseg.sorted_segment_sums(torch.zeros(4, 1), torch.ones(4, dtype=torch.bool),
                                 method="scatter")


def test_no_atomic_reduction_in_the_segment_path():
    # float atomics reorder a sum from run to run; the encoder's sums must not
    from raht3dgs_tpu_torch.ops import voxelize

    for mod in (tseg, voxelize):
        src = inspect.getsource(mod)
        for op in ("index_add", "scatter_add", "scatter_reduce", "index_reduce"):
            assert op + "(" not in src and op + "_(" not in src, (mod.__name__, op)
