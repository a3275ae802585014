"""The sharded scan's plan (``ops/ds_scan.py:scan_plan``): which device
scans which tile, what moves between devices and what is counted as
crossing between shards, held case by case; the plain version run through
that plan with distinct device keys on CPU shards, bitwise the unsharded
plain pack; and, on a card, the kernel's sharded entry bitwise the plain
version and the unsharded kernel."""

import numpy as np
import pytest
import torch

from raht3dgs_tpu_torch.ops import ds_scan as ds

SIZES = {
    "equal": (250, 250, 250, 250),
    "unequal": (100, 300, 50, 550),
    "short shards, a halo over several": (1, 255, 2, 512),
    "empty shards": (0, 600, 0, 5),
    "one shard holds every row": (7, 0, 0, 0),
    "no rows": (0, 0, 0, 0),
}
KEYS = {
    "one device": ("a", "a", "a", "a"),
    "four devices": ("a", "b", "c", "d"),
    "pairs": ("a", "a", "b", "b"),
    "alternating": ("a", "b", "a", "b"),
}


def _holder(plan, r):
    """The shard holding global row r."""
    return next(j for j, p in enumerate(plan.shards) if p.start <= r < p.start + p.rows)


def _formula(sizes, frames, k, tile):
    """The docstring's count: 4FK (3H + 2(O - 1)T + 2(S - 1))."""
    plans = ds.shard_plan(sizes, tile)
    T = -(-sum(sizes) // tile)
    owners = sum(1 for p in plans if p.tiles)
    halo = sum(p.halo for p in plans)
    return 4 * frames * k * (3 * halo + (2 * (owners - 1) * T if T > 1 else 0)
                             + 2 * (len(sizes) - 1))


def _check_plan(sizes, keys, tile, frames=2, k=3):
    plan = ds.scan_plan(tuple(sizes), tuple(keys), tile, frames, k, 7)
    N, T = sum(sizes), -(-sum(sizes) // tile)
    assert (plan.n, plan.T) == (N, T)
    group_keys = list(dict.fromkeys(keys))
    assert [group_keys[g] for g in plan.group_of] == list(keys)
    # every tile in exactly one device's table, on the device of the shard
    # holding its first row, and each local index once
    owned = {}
    for gi, g in enumerate(plan.groups):
        local = 0
        for s in g.segments:
            if not s.tiles:
                continue
            assert not s.received and s.local0 == local
            local += s.tiles
            for t in range(s.tile0, s.tile0 + s.tiles):
                assert t not in owned
                owned[t] = gi
                assert _holder(plan, t * tile) == s.shard
                assert plan.group_of[s.shard] == gi
        assert local == g.tiles
    assert sorted(owned) == list(range(T))
    # each device that scans receives every total it lacks, once, from the
    # device that owns it
    for gi, g in enumerate(plan.groups):
        if not g.tiles or T <= 1:
            assert not g.totals_in
            continue
        have = [t for t in range(T) if owned[t] == gi]
        for e, t0, t1 in g.totals_in:
            assert e != gi and t0 < t1
            assert all(owned[t] == e for t in range(t0, t1))
            have += range(t0, t1)
        assert sorted(have) == list(range(T))
    # every row written once: by the device owning its tile, into the
    # segment holding it there; a received segment is its shard's first
    # rows, returned to that shard's device
    for r in range(N):
        g = plan.groups[owned[r // tile]]
        segs = [s for s in g.segments if s.start <= r < s.start + s.rows]
        assert len(segs) == 1
        s = segs[0]
        assert s.shard == _holder(plan, r)
        if s.received:
            assert s.start == plan.shards[s.shard].start
            assert s.rows <= plan.shards[s.shard].rows
            assert plan.group_of[s.shard] != owned[r // tile]
        else:
            assert plan.group_of[s.shard] == owned[r // tile]
    # every leading row written once: by pass 2 on the shard's device where
    # the tile of its row before is scanned there, else copied
    for j, p in enumerate(plan.shards):
        writers = [s for g in plan.groups for s in g.segments if s.shard == j and s.writes_lead]
        assert len(writers) + (j in plan.lead_copies) == 1
        if writers:
            assert owned[max(p.start - 1, 0) // tile] == plan.group_of[j]
    assert list(plan.lead_copies) == sorted(plan.lead_copies)
    # the counted bytes
    assert plan.sent_bytes == _formula(sizes, frames, k, tile)
    return plan


@pytest.mark.parametrize("keys", list(KEYS.values()), ids=list(KEYS))
@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_plan_covers_and_moves(sizes, keys):
    _check_plan(sizes, keys, ds.PLAIN_BLOCK)
    _check_plan(sizes, keys, 64)


@pytest.mark.parametrize("keys", list(KEYS.values()), ids=list(KEYS))
def test_plan_past_the_carry_limit(keys):
    """More than MAX_CARRY_TILES tiles (2-row tiles): the plan is the same
    function of the tile count."""
    sizes = (3001, 2, 1999, 1)
    plan = _check_plan(sizes, keys, 2)
    assert plan.T > ds.MAX_CARRY_TILES


def test_plan_one_copy_per_range():
    """Co-resident owners' totals arrive as one range; alternating devices
    as one range per owner; one device receives nothing."""
    sizes = (1024, 1024, 1024, 1024)
    one = ds.scan_plan(sizes, ("a",) * 4, 256, 1, 4, 32)
    assert len(one.groups) == 1 and not one.groups[0].totals_in
    assert one.lead_copies == () and all(s.writes_lead for s in one.groups[0].segments)
    pairs = ds.scan_plan(sizes, ("a", "a", "b", "b"), 256, 1, 4, 32)
    assert [g.totals_in for g in pairs.groups] == [((1, 8, 16),), ((0, 0, 8),)]
    alt = ds.scan_plan(sizes, ("a", "b", "a", "b"), 256, 1, 4, 32)
    assert [g.totals_in for g in alt.groups] == [((1, 4, 8), (1, 12, 16)),
                                                 ((0, 0, 4), (0, 8, 12))]


def _split(x, sizes, dim):
    return [c.contiguous() for c in torch.split(x, list(sizes), dim=dim)]


@pytest.mark.parametrize("form", ["single", "batched"])
@pytest.mark.parametrize("keys", list(KEYS.values()), ids=list(KEYS))
@pytest.mark.parametrize("sizes", list(SIZES.values())[:5], ids=list(SIZES)[:5])
def test_plain_through_the_plan_bitwise(sizes, keys, form):
    """The plain version with distinct device keys on CPU shards runs every
    move between devices as a copy: each shard's pack stays bitwise its
    rows of the unsharded plain pack, and the count is the formula."""
    rng = np.random.default_rng(sum(sizes) + len(set(keys)))
    n, K = sum(sizes), 3
    shape = (n, K) if form == "single" else (2, n, K)
    x = torch.from_numpy(rng.normal(0.0, 100.0, shape).astype(np.float32))
    dim = 0 if form == "single" else 1
    want = (ds.ds_prefix_pack_reference(x) if form == "single"
            else ds.ds_prefix_pack_batched_reference(x))
    sent = []
    got = ds.ds_prefix_pack_sharded_reference(
        _split(x, sizes, dim), send=lambda t, dev: sent.append(t.numel() * t.element_size()),
        keys=keys)
    a = 0
    for g, m in zip(got, sizes):
        assert torch.equal(g, want[a:a + m + 1] if form == "single" else want[:, a:a + m + 1])
        a += m
    assert sum(sent) == _formula(sizes, 1 if form == "single" else 2, K, ds.PLAIN_BLOCK)


def test_plain_keys_refused():
    with pytest.raises(ValueError, match="keys"):
        ds.ds_prefix_pack_sharded_reference([torch.zeros(4, 2)] * 2, keys=["a"])


# -- on a card ----------------------------------------------------------------


CUDA_CASES = [
    # (shape, shard sizes): odd K, leads off 16 bytes, a stack, the wide
    # path, short shards, more than 2048 tiles
    ((600_001, 1), (150_001, 150_000, 150_000, 150_000)),
    ((600_000, 4), (150_000,) * 4),
    ((3, 70_001, 9), (17_501, 17_500, 17_500, 17_500)),
    ((5000, 12), (1250,) * 4),
    ((2, 20_000, 3), (6_667, 6_667, 6_666)),
    ((1 << 21, 4), (1 << 19,) * 4),
    ((1 << 21, 1), (1 << 19,) * 4),
    ((4, 1 << 18, 7), (1 << 17, 1 << 17)),
    (((1 << 22) + 5000, 2), (1_399_768, 1_399_768, 1_399_768)),
    (((1 << 22) + 5000, 9), (1_399_768, 1_399_768, 1_399_768)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sizes", CUDA_CASES)
def test_cuda_sharded_kernel_bitwise(shape, sizes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(sum(sizes))
    x = torch.rand(*shape, generator=gen) * 3.0
    x[..., -1] = (x[..., -1] > 1.5).float()
    x = x.cuda()
    dim = x.dim() - 2
    xs = _split(x, sizes, dim)
    whole = ds.ds_prefix_pack(x) if dim == 0 else ds.ds_prefix_pack_batched(x)
    ref = ds.ds_prefix_pack_reference(x) if dim == 0 else ds.ds_prefix_pack_batched_reference(x)
    plain = ds.ds_prefix_pack_sharded_reference(xs)
    ds.reset_launches()
    got = ds.ds_prefix_pack_sharded(xs)
    assert ds.LAUNCHES["ds_cumsum_sharded"] == 1
    for _ in range(3):
        again = ds.ds_prefix_pack_sharded(xs)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    a = 0
    for g, p, m in zip(got, plain, sizes):
        rows = (slice(a, a + m + 1),) if dim == 0 else (slice(None), slice(a, a + m + 1))
        assert torch.equal(g, whole[rows])
        assert torch.equal(p, ref[rows])
        a += m
