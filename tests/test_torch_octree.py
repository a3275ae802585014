"""The port's octree occupancy helpers against the JAX package's (numpy in
and out in both packages: every output must be equal, dtype included)."""

import numpy as np
import pytest

from conftest import unique_voxel_cloud
from raht3dgs_tpu.ops import octree as jo
from raht3dgs_tpu_torch.ops import octree as to


def _codes(n, depth, seed=0):
    _, codes, _ = unique_voxel_cloud(np.random.default_rng(seed), n, depth)
    return codes


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,depth", [(1, 1), (8, 1), (50, 3), (2000, 6), (3000, 10),
                                     (500, 17)])
def test_levels_serialize_deserialize_match_jax(n, depth):
    codes = _codes(n, depth)
    tl, tocc = to.octree_levels(codes, depth)
    jl, jocc = jo.octree_levels(codes, depth)
    assert len(tl) == len(jl) == depth
    assert all(_equal(a, b) for a, b in zip(tl, jl))
    assert all(_equal(a, b) for a, b in zip(tocc, jocc))
    occ = to.octree_serialize(codes, depth)
    assert _equal(occ, jo.octree_serialize(codes, depth))
    assert _equal(to.occupancy_level_sizes(occ, depth), jo.occupancy_level_sizes(occ, depth))
    for dtype in (np.uint64, np.int64):
        got = to.octree_deserialize(occ, depth, dtype=dtype)
        assert _equal(got, jo.octree_deserialize(occ, depth, dtype=dtype))
        assert np.array_equal(got.astype(np.int64), codes)


@pytest.mark.parametrize("depth", [2, 5, 9])
def test_level_neighbors6_matches_jax(depth):
    codes = _codes(4000, depth, seed=depth)
    levels, _ = to.octree_levels(codes, depth)
    for lvl, lc in enumerate(levels):
        assert _equal(to.level_neighbors6(lc, lvl), jo.level_neighbors6(lc, lvl))
    assert _equal(to.level_neighbors6(codes, depth), jo.level_neighbors6(codes, depth))


def test_compact_spread_match_jax():
    x = np.random.default_rng(1).integers(0, 2**63, 1000, dtype=np.uint64)
    assert _equal(to._compact3(x), jo._compact3(x))
    assert _equal(to._spread3(x), jo._spread3(x))
    assert np.array_equal(to._compact3(to._spread3(x)), x & np.uint64(0x1FFFFF))
    assert _equal(to._BITS8, jo._BITS8) and _equal(to._POPCOUNT8, jo._POPCOUNT8)


@pytest.mark.parametrize("case", ["empty", "unsorted", "duplicate", "negative", "too_wide",
                                  "depth0", "two_d"])
def test_levels_refuse_what_jax_refuses(case):
    codes, depth = {
        "empty": (np.array([], np.int64), 3),
        "unsorted": (np.array([5, 3], np.int64), 3),
        "duplicate": (np.array([3, 3], np.int64), 3),
        "negative": (np.array([-1, 3], np.int64), 3),
        "too_wide": (np.array([1, 512], np.int64), 3),
        "depth0": (np.array([0], np.int64), 0),
        "two_d": (np.zeros((2, 2), np.int64), 3),
    }[case]
    for mod in (to, jo):
        with pytest.raises(ValueError):
            mod.octree_levels(codes, depth)


@pytest.mark.parametrize("case", ["zero_byte", "truncated", "trailing"])
def test_deserialize_refuses_what_jax_refuses(case):
    occ = to.octree_serialize(_codes(200, 4), 4)
    bad = {"zero_byte": np.concatenate([[0], occ[1:]]).astype(np.uint8),
           "truncated": occ[:-1], "trailing": np.concatenate([occ, [1]]).astype(np.uint8)}[case]
    for mod in (to, jo):
        with pytest.raises(ValueError):
            mod.octree_deserialize(bad, 4)
    if case != "zero_byte":
        for mod in (to, jo):
            with pytest.raises(ValueError):
                mod.occupancy_level_sizes(bad, 4)
