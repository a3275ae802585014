"""The point-sharded span codec (``parallel/sp_span.py``) and the scan's
sharded entry (``ops/ds_scan.py:ds_prefix_pack_sharded``) on virtual CPU
meshes, against the port's unsharded functions on the same seeded numpy
input, and against the JAX package's batched forward.

Tolerances: every sharded output ``torch.equal`` to the unsharded call's,
float32 and float64 (the CPU's float64 cumsum adds in row order, so the
carry-first sums are bitwise too); the sharded plain scan bitwise the
plain scan. The exchange is counted to the byte by the formulas in the
two modules' docstrings. Against the JAX package (float64, non-integer
attributes): coefficients within 1e-12 of the largest (XLA:CPU fuses some
multiply-adds), stream orders equal."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from conftest import unique_voxel_cloud
from raht3dgs_tpu.parallel import sharding as js
from raht3dgs_tpu_torch.models import batch_codec as tbc
from raht3dgs_tpu_torch.models import pipeline as tp
from raht3dgs_tpu_torch.ops import ds_scan as ds
from raht3dgs_tpu_torch.ops import raht_span as rs
from raht3dgs_tpu_torch.ops.raht import num_levels
from raht3dgs_tpu_torch.parallel import sharding as tsh
from raht3dgs_tpu_torch.parallel import sp_span

CPU8 = [torch.device("cpu")] * 8
DEPTH, N, D, BATCH = 5, 512, 8, 8
MESHES = {"dp4_sp2": dict(dp=4, sp=2), "dp2_sp4": dict(dp=2, sp=4),
          "dp2_sp2_tp2": dict(dp=2, sp=2, tp=2)}
_TORCH = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(dtype=np.float64, batch=BATCH, d=D, n=N, depth=DEPTH):
    frames = [ge._synthetic_frame(n, depth, d, seed=s) for s in range(batch)]
    return tuple(torch.from_numpy(np.stack([f[i] for f in frames]).astype(dt))
                 for i, dt in ((0, frames[0][0].dtype), (1, dtype), (2, dtype)))


def _padded_batch(depth, n_real, bucket, dtype, seed=0, batch=2, d=3):
    """Frames of a depth from the conftest cloud through the port's own
    padding (``prepare_voxel_frame``): nvox < N, pad codes past the real
    ones (the flipped int64 tier at depth 21)."""
    rng = np.random.default_rng(seed)
    frames = []
    for b in range(batch):
        pts, _, attrs = unique_voxel_cloud(rng, n_real - 37 * b, depth, d_attr=d)
        frames.append(tp.prepare_voxel_frame(pts.astype(np.int64), attrs, depth,
                                             bucket=bucket, dtype=dtype, device="cpu"))
    stack = [torch.stack([getattr(f, k) for f in frames])
             for k in ("codes", "attributes", "weights")]
    return stack, torch.tensor([f.n_voxels for f in frames], dtype=torch.int32)


def _split(x, sizes, dim):
    return [c.contiguous() for c in torch.split(x, sizes, dim=dim)]


# -- the sharded scan ---------------------------------------------------------


def _plain_pack_bytes(sizes, F, K, tile):
    """``ds_prefix_pack_sharded``'s documented exchange: 4FK (3 * halo rows
    + 2 (owners - 1) T + 2 (S - 1))."""
    plans = ds.shard_plan(sizes, tile)
    T = -(-sum(sizes) // tile)
    owners = sum(1 for p in plans if p.tiles)
    halo = sum(p.halo for p in plans)
    return 4 * F * K * (3 * halo + (2 * (owners - 1) * T if T > 1 else 0)
                        + 2 * (len(sizes) - 1))


@pytest.mark.parametrize("K", [1, 4, 57])
@pytest.mark.parametrize("form", ["single", "batched"])
def test_sharded_plain_scan_bitwise(K, form):
    """Shard edges inside the plain version's 256-row blocks, equal and
    unequal shards, one shard without a block start of its own, and more
    than 256 blocks (the carries' own recursion): every shard's pack is
    bitwise its rows of the unsharded plain pack, and the exchange counts
    as documented."""
    rng = np.random.default_rng(K)
    for sizes in ([250] * 4, [100, 300, 50, 550], [1, 255, 2, 512], [33000, 33000]):
        n = sum(sizes)
        shape = (n, K) if form == "single" else (3, n, K)
        x = torch.from_numpy(rng.normal(0.0, 100.0, shape).astype(np.float32))
        x[..., -1] = (x[..., -1] > 0).float()       # an integer lane
        dim = 0 if form == "single" else 1
        want = (ds.ds_prefix_pack_reference(x) if form == "single"
                else ds.ds_prefix_pack_batched_reference(x))
        counts = {}
        group = sp_span.SpGroup(CPU8[:len(sizes)], sizes, counts)
        got = ds.ds_prefix_pack_sharded(_split(x, sizes, dim), send=group.send)
        a = 0
        for g, m in zip(got, sizes):
            assert torch.equal(g, want[a:a + m + 1] if form == "single" else want[:, a:a + m + 1])
            a += m
        F = 1 if form == "single" else 3
        assert counts["sp_exchange_bytes"] == _plain_pack_bytes(sizes, F, K, ds.PLAIN_BLOCK)


def test_sharded_scan_refusals():
    """Shards that disagree in frames or columns, or mix devices, raise."""
    x = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="differ"):
        ds.ds_prefix_pack_sharded([x, torch.zeros(8, 4)])
    with pytest.raises(TypeError):
        ds.ds_prefix_pack_sharded([x, x.double()])


# -- the batched functions on sp meshes ---------------------------------------


def _every_function(codes, attrs, weights, nvox, steps, mesh, depth, tdt,
                    order_modes=("ragft", "weight_desc", "morton")):
    """Each batched function on the mesh's sharded values against the
    unsharded call; returns the names that differ."""
    bad = []

    def same(name, a, b):
        if not torch.equal(a, b):
            bad.append(name)

    cs, as_, ws = tsh.shard_batch(mesh, codes, attrs, weights)
    for om in order_modes:
        coeffs, order = tsh.batched_forward(codes, attrs, weights, depth, om, nvox)
        got = tsh.batched_forward(cs, as_, ws, depth, om, nvox)
        same(f"forward {om} coeffs", got[0], coeffs)
        same(f"forward {om} order", got[1], order)
        same(f"inverse_order {om}", tsh.batched_inverse_order(cs, ws, nvox, depth, om),
             tsh.batched_inverse_order(codes, weights, nvox, depth, om))
    coeffs, order = tsh.batched_forward(codes, attrs, weights, depth, "ragft", nvox)
    sc, so = tsh.shard(mesh, coeffs, ("dp", "sp", "tp")), tsh.shard(mesh, order, ("dp", "sp"))
    coeffs_T = tsh.batched_reorder_T(coeffs, order)
    same("reorder_T", tsh.batched_reorder_T(sc, so), coeffs_T)
    same("reorder_T plain order", tsh.batched_reorder_T(sc, order), coeffs_T)
    sT = tsh.shard(mesh, coeffs_T, ("dp", "tp", "sp"))
    qf = torch.tensor(0.3, dtype=tdt)
    for qm in ("mid", "deadzone"):
        q = tsh.batched_quant_T(coeffs_T, steps, qm, qf)
        same(f"quant_T {qm}", tsh.batched_quant_T(sT, steps, qm, qf), q)
        same(f"quant_reorder {qm}", tsh.batched_quant_reorder(sc, steps, so, qm, qf), q)
    q = tsh.batched_transform_step(codes, attrs, weights, steps, depth, nvox=nvox)
    same("transform_step", tsh.batched_transform_step(cs, as_, ws, steps, depth, nvox=nvox), q)
    inv = tsh.batched_inverse_order(codes, weights, nvox, depth)
    delta = torch.tensor(0.25, dtype=tdt)
    for qm in ("mid", "deadzone"):
        rec = tsh.batched_decode_step(codes, weights, q, inv, steps, depth, tdt, qm, delta)
        same(f"decode {qm}", tsh.batched_decode_step(cs, ws, q, inv, steps, depth, tdt, qm,
                                                      delta), rec)
    rec = tsh.batched_decode_step(codes, weights, q, inv, steps, depth, tdt)
    same("decode, symbols and inverse order split over sp", tsh.batched_decode_step(
        cs, ws, tsh.shard(mesh, q, ("dp", "tp", "sp")), tsh.shard(mesh, inv, ("dp", "sp")),
        steps, depth, tdt), rec)
    step = torch.tensor(2.0, dtype=tdt)
    same("roundtrip", tsh.batched_roundtrip_step(cs, as_, ws, step, depth),
         tsh.batched_roundtrip_step(codes, attrs, weights, step, depth))
    return bad


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mesh_kw", list(MESHES.values()), ids=list(MESHES))
def test_every_function_bitwise(mesh_kw, dtype):
    """Forward (ragft, weight_desc, morton), reorder, both quantizers,
    transform step, inverse order and decode (mid, deadzone), roundtrip:
    bitwise the unsharded calls on padded frames; no point shard gathered,
    the exchange counted."""
    codes, attrs, weights = _batch(dtype)
    tdt = _TORCH[dtype]
    nvox = torch.tensor([N - 40 * (b % 3) for b in range(BATCH)], dtype=torch.int32)
    steps = torch.linspace(2.0, 5.0, D, dtype=tdt)
    mesh = tsh.make_mesh(8, devices=CPU8, **mesh_kw)
    tsh.reset_counts()
    assert _every_function(codes, attrs, weights, nvox, steps, mesh, DEPTH, tdt) == []
    assert tsh.COUNTS["sp_gather_bytes"] == 0 and tsh.COUNTS["sp_exchange_bytes"] > 0


@pytest.mark.parametrize("inverse", ["chain", "fill"])
@pytest.mark.parametrize("nge", ["flat", "tiered"])
def test_inverse_and_nearest_ge_modes(monkeypatch, inverse, nge):
    """``RAHT3DGS_SPAN_INVERSE`` chain / fill and ``RAHT3DGS_NEARESTGE``
    flat / tiered (the tiered plan needs N >= 8192) on sp = 2 and 4, f32
    and f64: the forward, the structure pass and the decode bitwise."""
    monkeypatch.setenv("RAHT3DGS_SPAN_INVERSE", inverse)
    monkeypatch.setattr(rs, "_NGE_MODE", nge)
    n, depth = 8192, 6
    for dtype in (np.float32, np.float64):
        codes, attrs, weights = _batch(dtype, batch=2, d=3, n=n, depth=depth)
        assert rs._nge_tier_plan(n, num_levels(depth, n) + 2) is not None
        tdt = _TORCH[dtype]
        nvox = torch.tensor([n - 100, n], dtype=torch.int32)
        steps = torch.tensor([3.0], dtype=tdt)
        q = tsh.batched_transform_step(codes, attrs, weights, steps, depth, nvox=nvox)
        inv = tsh.batched_inverse_order(codes, weights, nvox, depth)
        rec = tsh.batched_decode_step(codes, weights, q, inv, steps, depth, tdt)
        for sp in (2, 4):
            mesh = tsh.make_mesh(sp, sp=sp, devices=CPU8[:sp])
            cs, as_, ws = tsh.shard_batch(mesh, codes, attrs, weights)
            assert torch.equal(tsh.batched_transform_step(cs, as_, ws, steps, depth,
                                                          nvox=nvox), q)
            assert torch.equal(tsh.batched_inverse_order(cs, ws, nvox, depth), inv)
            assert torch.equal(tsh.batched_decode_step(cs, ws, q, inv, steps, depth, tdt), rec)


def test_f64_sums_of_float32_frames(monkeypatch):
    """``RAHT3DGS_SPAN_SUMS=f64`` on float32 frames: the carry-first
    float64 cumsums give the unsharded bits on the CPU."""
    monkeypatch.setattr(rs, "_SUM_MODE", "f64")
    codes, attrs, weights = _batch(np.float32, batch=4)
    steps = torch.linspace(2.0, 5.0, D, dtype=torch.float32)
    mesh = tsh.make_mesh(8, devices=CPU8, dp=2, sp=4)
    assert _every_function(codes, attrs, weights, None, steps, mesh, DEPTH, torch.float32,
                           order_modes=("ragft",)) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_j21_padded_frames(dtype):
    """Depth-21 frames (the flipped int64 codes) padded past their voxels
    (nvox < N) on sp = 2 and 4: transform step, inverse order and decode
    bitwise the unsharded calls."""
    (codes, attrs, weights), nvox = _padded_batch(21, 3000, 4096, dtype, seed=5)
    assert codes.dtype == torch.int64 and (codes[:, :2900] < 0).all()
    steps = torch.tensor([4.0], dtype=dtype)
    q = tsh.batched_transform_step(codes, attrs, weights, steps, 21, nvox=nvox)
    inv = tsh.batched_inverse_order(codes, weights, nvox, 21)
    rec = tsh.batched_decode_step(codes, weights, q, inv, steps, 21, dtype)
    for sp in (2, 4):
        mesh = tsh.make_mesh(sp, sp=sp, devices=CPU8[:sp])
        cs, as_, ws = tsh.shard_batch(mesh, codes, attrs, weights)
        assert torch.equal(tsh.batched_transform_step(cs, as_, ws, steps, 21, nvox=nvox), q)
        assert torch.equal(tsh.batched_inverse_order(cs, ws, nvox, 21), inv)
        assert torch.equal(tsh.batched_decode_step(cs, ws, q, inv, steps, 21, dtype), rec)


@pytest.mark.parametrize("depth", [5, 21])
def test_crossing_nodes_bound(depth):
    """The chain's crossing nodes number at most (sp - 1) * (levels + 2) a
    frame, and every shard edge has at least one."""
    if depth == 21:
        (codes, _, weights), _ = _padded_batch(21, 3000, 4096, torch.float64, seed=2)
    else:
        codes, _, weights = _batch(np.float64)
    for sp in (2, 4, 8):
        n = codes.shape[1] // sp
        grp = sp_span.SpGroup(CPU8[:sp], [n] * sp, {})
        cs = list(torch.split(codes, n, dim=1))
        ws = list(torch.split(weights, n, dim=1))
        W, w_total = sp_span.weight_prefix(grp, ws, torch.float64)
        topo = sp_span.topology(grp, cs, depth, W, w_total)
        count = sum(m.sum(dim=1) for m in sp_span.crossing_nodes(grp, topo))
        bound = (sp - 1) * (topo[0].levels + 2)
        assert bool((count <= bound).all()) and bool((count >= sp - 1).all()), (sp, count)


def _forward_bytes(sp, F, K, V, code_bytes, dtype):
    """``sp_span``'s documented exchange of :func:`sp_span.forward`."""
    c = 4 if dtype == torch.float32 else 8
    C = 2 * K if dtype == torch.float32 else K
    n = N // sp
    topo = (sp - 1) * F * code_bytes + 8 * (sp - 1) * F * V
    pack = (_plain_pack_bytes([n] * sp, F, K, ds.PLAIN_BLOCK) if dtype == torch.float32
            else 8 * (sp - 1) * F * K)
    return topo + pack + c * F * C + 2 * c * (sp - 1) * F * V * C


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exchange_bytes_as_documented(dtype):
    """The forward's exchange, counted by ``SpGroup.send``, equals the
    module docstring's formula."""
    codes, attrs, weights = _batch(np.float64 if dtype == torch.float64 else np.float32,
                                   batch=3)
    for sp in (2, 4):
        counts = {}
        grp = sp_span.SpGroup(CPU8[:sp], [N // sp] * sp, counts)
        split = [list(torch.split(x, N // sp, dim=1)) for x in (codes, attrs, weights)]
        sp_span.forward(grp, *split, DEPTH)
        V = num_levels(DEPTH, N) + 2
        assert counts["sp_exchange_bytes"] == _forward_bytes(
            sp, 3, D + 1, V, codes.element_size(), dtype)


def test_batch_codec_mesh_sp(rng):
    """``BatchAttributeCodec`` on a dp=2 x sp=2 mesh: the unsharded codec's
    stream bytes and decodes, with no point shard gathered."""
    pos, attrs = [], []
    for n in (300, 450, 200, 380):
        p, _, a = unique_voxel_cloud(rng, n, DEPTH, d_attr=3)
        pos.append(p.astype(np.int64))
        attrs.append(a)
    frames = tbc.prepare_frame_batch(pos, attrs, DEPTH, bucket=512, dtype=torch.float32,
                                     device="cpu")
    mesh = tsh.make_mesh(4, dp=2, sp=2, devices=CPU8[:4])
    plain = tbc.BatchAttributeCodec(DEPTH, dtype=torch.float32, device="cpu")
    codec = tbc.BatchAttributeCodec(DEPTH, dtype=torch.float32, mesh=mesh)
    tsh.reset_counts()
    streams, _ = codec.encode(frames, 2.0)
    want = [s.to_bytes() for s in plain.encode(frames, 2.0)[0]]
    assert [s.to_bytes() for s in streams] == want
    recs, _ = codec.decode(streams, frames, inv=codec.inverse_order(frames))
    for a, b in zip(recs, plain.decode(streams, frames)[0]):
        np.testing.assert_array_equal(a, b)
    assert tsh.COUNTS["sp_gather_bytes"] == 0 and tsh.COUNTS["sp_exchange_bytes"] > 0


def test_sharded_forward_matches_jax():
    """The forward on a dp=2 x sp=2 x tp=2 mesh against the JAX package's
    batched forward on its 8-device mesh (float64, non-integer
    attributes): coefficients within 1e-12 of the largest, orders equal."""
    codes, attrs, weights = (t.numpy() for t in _batch(np.float64))
    jmesh = js.make_mesh(8, dp=2, sp=2, tp=2)
    jc, ja, jw = js.shard_batch(jmesh, codes, attrs, weights)
    with jmesh:
        jcoef, jorder = js.batched_forward(jc, ja, jw, DEPTH)
    mesh = tsh.make_mesh(8, dp=2, sp=2, tp=2, devices=CPU8)
    coef, order = tsh.batched_forward(*tsh.shard_batch(
        mesh, *(torch.from_numpy(x) for x in (codes, attrs, weights))), DEPTH)
    jcoef = np.asarray(jcoef)
    assert np.abs(coef.numpy() - jcoef).max() <= 1e-12 * np.abs(jcoef).max()
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
