"""The port's double-single scan (plain version on the CPU) against the JAX
package's Pallas kernels in interpret mode and a float64 cumsum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.ops.pallas_scan import ds_cumsum_pallas, ds_cumsum_pallas_t
from raht3dgs_tpu_torch.ops import ds_scan
from raht3dgs_tpu_torch.ops.ds_scan import (
    LAUNCHES,
    ds_cumsum,
    ds_cumsum_reference,
    ds_cumsum_t,
)


def _total(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("n,k", [(1, 1), (2047, 3), (2048, 4), (10000, 8)])
def test_plain_matches_pallas_and_f64(rng, n, k):
    x = rng.normal(scale=1000, size=(n, k)).astype(np.float32)
    ref = np.cumsum(x.astype(np.float64), axis=0)
    hi, lo = ds_cumsum_reference(torch.from_numpy(x))
    got = _total(hi, lo)
    assert _rel_err(got, ref) < 1e-12
    ph, pl = ds_cumsum_pallas(jnp.asarray(x), interpret=True)
    assert _rel_err(got, _total(ph, pl)) < 1e-12


def test_plain_matches_f64_at_codec_pack_width(rng):
    # three block levels of the plain scan (70000 > 256 * 256)
    x = rng.normal(scale=300, size=(70000, 4)).astype(np.float32)
    hi, lo = ds_cumsum(torch.from_numpy(x))
    ref = np.cumsum(x.astype(np.float64), axis=0)
    assert _rel_err(_total(hi, lo), ref) < 1e-12


@pytest.mark.parametrize("n,k", [(100, 3), (2048, 4), (6000, 8)])
def test_transposed_entry_matches_pallas_t(rng, n, k):
    x = rng.normal(scale=500, size=(n, k)).astype(np.float32)
    hi, lo = ds_cumsum_t(torch.from_numpy(np.ascontiguousarray(x.T)))
    assert hi.shape == (k, n)
    got = _total(hi, lo).T
    ref = np.cumsum(x.astype(np.float64), axis=0)
    assert _rel_err(got, ref) < 1e-12
    ph, pl = ds_cumsum_pallas_t(jnp.asarray(x), interpret=True)
    assert _rel_err(got, _total(ph, pl)) < 1e-12


def test_cancellation_resistant():
    n = 4096
    x = np.empty((n, 1), dtype=np.float32)
    x[0::2, 0] = 1e7
    x[1::2, 0] = -1e7 + 1.0
    hi, lo = ds_cumsum(torch.from_numpy(x))
    ref = np.cumsum(x.astype(np.float64), axis=0)
    assert np.abs(_total(hi, lo) - ref).max() < 1e-3


def test_integer_lanes_bit_exact(rng):
    # weight-like lanes: integer counts whose partial sums stay < 2^24
    w = rng.integers(0, 4, size=(70000, 2)).astype(np.float32)
    hi, lo = ds_cumsum(torch.from_numpy(w))
    exact = np.cumsum(w.astype(np.int64), axis=0)
    assert np.array_equal(hi.numpy().astype(np.int64), exact)
    assert not lo.numpy().any()


def test_column_alone_equals_column_in_pack(rng):
    # the association depends on N alone: the encoder's fused-pack weight
    # column and the decoder's standalone weight scan agree bit for bit,
    # also for fractional values
    x = rng.normal(size=(5000, 4)).astype(np.float32)
    hi4, lo4 = ds_cumsum(torch.from_numpy(x))
    hi1, lo1 = ds_cumsum(torch.from_numpy(np.ascontiguousarray(x[:, 3:])))
    assert torch.equal(hi4[:, 3:], hi1) and torch.equal(lo4[:, 3:], lo1)


def test_cpu_tensor_takes_plain_path(rng, monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(ds_scan.KERNEL, "load", no_kernel)
    before = dict(LAUNCHES)
    x = torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32))
    hi, lo = ds_cumsum(x)
    rh, rl = ds_cumsum_reference(x)
    assert torch.equal(hi, rh) and torch.equal(lo, rl)
    assert LAUNCHES == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        ds_cumsum(torch.zeros(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        ds_cumsum(torch.zeros(4))
    # the launch path never takes a CPU tensor (no silent fallback inside)
    with pytest.raises(ValueError):
        ds_scan._launch(torch.zeros(4, 2), 4, 2, 2, 1, "ds_cumsum")


@pytest.mark.cuda
def test_cuda_tensor_launches_kernel(rng, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor must never take the plain path")

    monkeypatch.setattr(ds_scan, "_ds_scan_plain", no_plain)
    x = rng.normal(size=(70000, 4)).astype(np.float32)
    before = LAUNCHES["ds_cumsum"]
    hi, lo = ds_cumsum(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    assert LAUNCHES["ds_cumsum"] == before + 1
    ref = np.cumsum(x.astype(np.float64), axis=0)
    assert _rel_err(_total(hi.cpu(), lo.cpu()), ref) < 1e-12
