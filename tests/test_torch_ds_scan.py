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
    MAX_CARRY_TILES,
    TILE,
    ds_cumsum,
    ds_cumsum_reference,
    ds_cumsum_t,
    ds_prefix_pack,
    scratch_floats,
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


def _recount_scratch(n, k):
    # walk the kernel's launch plan level by level, adding up the floats
    # each level's scratch pointers span
    total = 0
    while True:
        tiles = -(-n // TILE)
        if tiles <= 1:
            return total
        total += 2 * tiles * k              # tile totals, hi and lo
        if tiles <= MAX_CARRY_TILES:
            return total
        total += 2 * tiles * k              # their inclusive scan, hi and lo
        n = tiles


@pytest.mark.parametrize("k", [1, 4, 8, 57, 60])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 1 << 19, 2048 * 2048,
                               2048 * 2048 + 1, (1 << 23) + 3, 2048 ** 3 + 5])
def test_scratch_floats_matches_recount(n, k):
    assert scratch_floats(n, k) == _recount_scratch(n, k)


def _recount_batched_scratch(b, n, k):
    # the batched entry's scratch as its pointers span it: one pass (2 to
    # 8 columns, 2..MAX_CARRY_TILES tiles a frame) takes up to 3 floats of
    # alignment, then each frame's (hi, lo) records (2k floats a tile) at a
    # 16-byte aligned stride, then a flag a tile and the ticket counter;
    # otherwise each frame takes the single entry's scratch
    tiles = -(-n // TILE)
    if not (2 <= k <= 8 and 2 <= tiles <= MAX_CARRY_TILES):
        return b * _recount_scratch(n, k)
    stride = 2 * tiles * k
    while stride % 4:
        stride += 1
    return 3 + b * stride + b * tiles + 1


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 9, 57])
@pytest.mark.parametrize("n", [2048, 2049, 1 << 20, 2048 * 2048, 2048 * 2048 + 1])
@pytest.mark.parametrize("b", [1, 4, 65535])
def test_batched_scratch_floats_matches_recount(b, n, k):
    assert ds_scan.batched_scratch_floats(b, n, k) == _recount_batched_scratch(b, n, k)


def test_scratch_floats_known_sizes():
    assert scratch_floats(1 << 19, 4) == 2 * 256 * 4     # the forward's pack
    assert scratch_floats(2048, 1) == 0                  # one tile, one launch
    assert scratch_floats((1 << 23) + 3, 1) == 4 * 4097 + 2 * 3
    # the wide path counts a totals row of all K columns
    assert scratch_floats(487_180, 57) == 2 * 238 * 57   # the 3DGS transform's pack
    assert scratch_floats(2_000_000, 60) == 2 * 977 * 60  # the Gaussian merge's prefix
    # the batched entry: the dataset path's pack in one pass (records,
    # flags, counter); its one-column weight scans, one tile per frame and
    # past the one-block carry as the single entry's scratch a frame
    batched = ds_scan.batched_scratch_floats
    assert batched(4, 1 << 20, 4) == 3 + 4 * 512 * 8 + 4 * 512 + 1
    assert batched(4, 1 << 20, 1) == 4 * scratch_floats(1 << 20, 1)
    assert batched(3, 4097, 2) == 3 + 3 * 12 + 3 * 3 + 1
    assert batched(3, 600_001, 3) == 3 + 3 * 1760 + 3 * 293 + 1   # 293 * 6 = 1758 -> 1760
    assert batched(1, 2048, 1) == 0
    assert batched(2, (1 << 22) + 5, 4) == 2 * scratch_floats((1 << 22) + 5, 4)
    assert batched(2, 1 << 19, 57) == 2 * scratch_floats(1 << 19, 57)


@pytest.mark.parametrize("n,k", [(1, 1), (7, 1), (300, 4), (2049, 3), (5000, 4)])
def test_prefix_pack_matches_pallas_pack(rng, n, k):
    # the JAX package's f32 prefix pack from its Pallas kernel: a zero row,
    # then [hi | lo]; integer lanes bit for bit, float lanes to 1e-12
    x = rng.normal(scale=10, size=(n, k)).astype(np.float32)
    x[:, -1] = rng.integers(0, 4, size=n)
    P = ds_prefix_pack(torch.from_numpy(x)).numpy()
    ph, pl = (np.asarray(a) for a in ds_cumsum_pallas(jnp.asarray(x), interpret=True))
    want = np.concatenate([np.zeros((1, 2 * k), np.float32),
                           np.concatenate([ph, pl], axis=1)])
    assert P.shape == want.shape and P.dtype == np.float32
    assert not P[0].any()
    assert np.array_equal(P[:, [k - 1, 2 * k - 1]], want[:, [k - 1, 2 * k - 1]])
    assert _rel_err(_total(P[:, :k], P[:, k:]), _total(want[:, :k], want[:, k:])) < 1e-12


def test_cpu_prefix_pack_takes_plain_path(rng, monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(ds_scan.KERNEL, "load", no_kernel)
    before = dict(LAUNCHES)
    P = ds_prefix_pack(torch.zeros(0, 4))
    assert P.shape == (1, 8) and not P.any()
    x = torch.from_numpy(rng.uniform(0.5, 3.0, size=(500, 1)).astype(np.float32))
    P = ds_prefix_pack(x)
    hi, lo = ds_cumsum_reference(x)
    assert torch.equal(P[1:, :1], hi) and torch.equal(P[1:, 1:], lo)
    assert LAUNCHES == before


def test_wrapper_checks_pack_and_launch_arguments():
    with pytest.raises(TypeError):
        ds_prefix_pack(torch.zeros(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        ds_prefix_pack(torch.zeros(4))
    # any K >= 1 goes to the kernel: a wide row is refused only for what
    # any row is refused for
    with pytest.raises(ValueError, match="column"):
        ds_scan._launch(torch.zeros(4, 0), 4, 0, 0, 1, "ds_cumsum", pack=True)
    with pytest.raises(ValueError, match="CUDA"):
        ds_scan._launch(torch.zeros(4, 57), 4, 57, 57, 1, "ds_cumsum", pack=True)
    with pytest.raises(ValueError, match="contiguous"):
        ds_scan._launch(torch.zeros(4, 120)[:, :57], 4, 57, 57, 1, "ds_cumsum")
    with pytest.raises(ValueError, match="contiguous"):
        ds_scan._launch(torch.zeros(4, 6)[:, :2], 4, 2, 2, 1, "ds_cumsum")
    with pytest.raises(ValueError, match="CUDA"):
        ds_scan._launch(torch.zeros(4, 2), 4, 2, 2, 1, "ds_cumsum", pack=True)


@pytest.mark.cuda
def test_cuda_bitwise_invariants_fractional(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from raht3dgs_tpu_torch.ops.raht_span import _prefix_pack

    x = torch.from_numpy(rng.uniform(0, 3, size=(70000, 4)).astype(np.float32)).cuda()
    hi, lo = ds_cumsum(x)
    h2, l2 = ds_cumsum(x)
    assert torch.equal(hi, h2) and torch.equal(lo, l2)            # run to run
    for k in range(4):                                            # K-independent
        h1, l1 = ds_cumsum(x[:, k:k + 1].contiguous())
        assert torch.equal(hi[:, k:k + 1], h1) and torch.equal(lo[:, k:k + 1], l1)
    ht, lt = ds_cumsum_t(x.T.contiguous())                        # layout-independent
    assert torch.equal(ht.T, hi) and torch.equal(lt.T, lo)
    want = torch.cat([torch.zeros(1, 8, device="cuda"), torch.cat([hi, lo], dim=1)])
    assert torch.equal(_prefix_pack(x, True), want)               # kernel-written pack
    # the kernel refuses, without launching, scratch one float short
    lib = ds_scan.KERNEL.load()
    for n in (2049, 1 << 19, (1 << 23) + 3):
        assert lib.ds_cumsum_f32(None, n, 4, 4, 1, 1, None, None,
                                 scratch_floats(n, 4) - 1, None) == -3


def test_transform_prefix_pack_at_3dgs_width(rng):
    # the float32 56-channel transform's fused pack: sqrt(w)-scaled
    # attributes and the weight lane, K = 57, in one ds_prefix_pack call
    # (the plain pack on the CPU), equal to the JAX package's Pallas pack
    from raht3dgs_tpu_torch.ops.raht_span import _prefix_pack

    body = rng.normal(scale=3, size=(3000, 57)).astype(np.float32)
    body[:, -1] = rng.integers(0, 3, size=3000)
    P = _prefix_pack(torch.from_numpy(body), True)
    assert torch.equal(P, ds_scan.ds_prefix_pack_reference(torch.from_numpy(body)))
    ph, pl = (np.asarray(a) for a in ds_cumsum_pallas(jnp.asarray(body), interpret=True))
    assert np.array_equal(P[1:, [56, 113]].numpy(), np.stack([ph[:, 56], pl[:, 56]], 1))
    assert _rel_err(_total(P[1:, :57], P[1:, 57:]), _total(ph, pl)) < 1e-12


@pytest.mark.cuda
def test_cuda_wide_pack_invariants(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from raht3dgs_tpu_torch.ops.raht_span import _prefix_pack

    # one tile with a ragged last column block, full column blocks only, a
    # tile count off the wave, the one-block carry's last tile count (2048)
    # and the recursive carry's first (2049), and past it
    for n, k in ((70000, 57), (2049, 9), (2048, 17), (70000, 16), ((1 << 19) + 3, 57),
                 (2048 * 2048, 12), (2048 * 2048 + 1, 12), ((1 << 22) + 5, 12)):
        x = torch.from_numpy(rng.uniform(0, 3, size=(n, k)).astype(np.float32)).cuda()
        P = _prefix_pack(x, True)
        assert torch.equal(P, ds_prefix_pack(x))                    # run to run
        assert P.shape == (n + 1, 2 * k) and not P[0].any()
        hi, lo = ds_cumsum(x)
        assert torch.equal(P[1:, :k], hi) and torch.equal(P[1:, k:], lo)
        for c in (0, 7, 8, k - 1):                                  # K-independent
            h1, l1 = ds_cumsum(x[:, c:c + 1].contiguous())
            assert torch.equal(hi[:, c:c + 1], h1) and torch.equal(lo[:, c:c + 1], l1)
        ht, lt = ds_cumsum_t(x.T.contiguous())                      # layout-independent
        assert torch.equal(ht.T, hi) and torch.equal(lt.T, lo)
        ref = torch.cumsum(x.double(), 0)
        got = hi.double() + lo.double()
        assert float((got - ref).abs().max()) / float(ref.abs().max()) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2048, 1), (3, 600_001, 3), (5, 2048 * 2048, 4),
                                   (2, (1 << 22) + 5, 4), (64, 4096, 8), (1, 1 << 21, 4),
                                   (4, 1 << 20, 1), (3, 600_001, 1), (3, 5001, 2),
                                   (2, 6145, 5), (3, 4097, 6), (2, 2049, 7)])
def test_cuda_batched_one_pass_bitwise_single_entry(rng, shape):
    # the batched entry (one pass at 2 to 8 columns and 2 to 2048 tiles a
    # frame, blocks waiting on each other's published totals; one column on
    # the two passes): frame by frame the
    # single entry's bits, and equal over repeated calls (a race would show
    # as a call that differs)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, N, K = shape
    x = rng.uniform(0, 3, size=shape).astype(np.float32)
    x[..., -1] = x[..., -1] > 1.5
    x = torch.from_numpy(x).cuda()
    P = ds_scan.ds_prefix_pack_batched(x)
    hi, lo = ds_scan.ds_cumsum_batched(x)
    for b in range(B):
        assert torch.equal(P[b], ds_prefix_pack(x[b]))
        h1, l1 = ds_cumsum(x[b])
        assert torch.equal(hi[b], h1) and torch.equal(lo[b], l1)
    for _ in range(20):
        assert torch.equal(ds_scan.ds_prefix_pack_batched(x), P)
        h2, l2 = ds_scan.ds_cumsum_batched(x)
        assert torch.equal(h2, hi) and torch.equal(l2, lo)
    # the kernel refuses, without launching, scratch one float short
    need = ds_scan.batched_scratch_floats(B, N, K)
    assert ds_scan.KERNEL.load().ds_cumsum_batched_f32(None, B, N, K, 1, None, None,
                                                       need - 1, None) == -3
