"""The port's lossless geometry coder against the JAX package's.

For each of the six profiles the section bytes of the port's native
library, of its plain twin (``backend="python"``) and of the JAX package
must be equal, and each package must decode the other's section (full
decode and every LOD level). Decoded codes match dtype and value.
"""

import numpy as np
import pytest
import torch

from conftest import unique_voxel_cloud
from raht3dgs_tpu.codec import geometry as jg
from raht3dgs_tpu_torch.codec import geometry as tg
from raht3dgs_tpu_torch.ops.morton import morton_decode

DEPTH = 8
# profile -> (ext3, temporal, motion)
PROFILES = {0: (False, False, None), 1: (False, True, None), 2: (False, True, (2, -1, 0)),
            3: (True, False, None), 4: (True, True, None), 5: (True, True, (-3, 0, 1))}


def _frames(n=1500, depth=DEPTH, seed=0):
    """A frame's sorted codes and a previous frame sharing about half of
    them (the temporal profiles' reference)."""
    rng = np.random.default_rng(seed)
    _, codes, _ = unique_voxel_cloud(rng, n, depth)
    extra = rng.integers(0, 8 ** depth, n // 3)
    prev = np.unique(np.concatenate([codes[::2], extra])).astype(np.int64)
    return codes, prev


def _encode_kw(profile, prev):
    ext3, temporal, motion = PROFILES[profile]
    kw = {"ext3": ext3}
    if temporal:
        kw["prev_codes"] = prev
        kw["motion"] = motion
    return kw


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_profile_bytes_and_decodes_match_jax(profile):
    codes, prev = _frames(seed=profile)
    kw = _encode_kw(profile, prev)
    dec_kw = {"prev_codes": prev} if "prev_codes" in kw else {}
    got = tg.encode_geometry(codes, DEPTH, **kw)
    assert got[0] == profile
    assert got == jg.encode_geometry(codes, DEPTH, **kw)
    assert got == tg.encode_geometry(codes, DEPTH, backend="python", **kw)
    want = jg.decode_geometry(got, DEPTH, len(codes), **dec_kw)
    for backend in tg.BACKENDS:
        out = tg.decode_geometry(got, DEPTH, len(codes), backend=backend, **dec_kw)
        assert _equal(out, want) and np.array_equal(out, codes)
    for dtype in (np.uint64, np.int64):
        assert _equal(tg.decode_geometry(got, DEPTH, len(codes), dtype=dtype, **dec_kw),
                      jg.decode_geometry(got, DEPTH, len(codes), dtype=dtype, **dec_kw))


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_lod_every_level_matches_jax(profile):
    codes, prev = _frames(n=800, seed=10 + profile)
    kw = _encode_kw(profile, prev)
    dec_kw = {"prev_codes": prev} if "prev_codes" in kw else {}
    blob = jg.encode_geometry(codes, DEPTH, **kw)
    for level in range(1, DEPTH + 1):
        want = jg.decode_geometry_lod(blob, DEPTH, len(codes), level, **dec_kw)
        for backend in tg.BACKENDS:
            got = tg.decode_geometry_lod(blob, DEPTH, len(codes), level, backend=backend,
                                         **dec_kw)
            assert _equal(got, want), (level, backend)
        assert np.array_equal(want.astype(np.int64),
                              np.unique(codes >> (3 * (DEPTH - level))))
    with pytest.raises(ValueError, match="lod level"):
        tg.decode_geometry_lod(blob, DEPTH, len(codes), 0, **dec_kw)


@pytest.mark.parametrize("n,mode,profile", [
    (16383, None, 0), (16384, None, 3),            # the size-adaptive default
    (16384, "legacy", 0), (16383, "ext3", 3),      # RAHT3DGS_GEOM_CONTEXTS forces it
])
def test_ext3_choice_around_16384_voxels_matches_jax(monkeypatch, n, mode, profile):
    if mode is not None:
        monkeypatch.setenv("RAHT3DGS_GEOM_CONTEXTS", mode)
    _, codes, _ = unique_voxel_cloud(np.random.default_rng(7), 3 * n, 9)
    codes = codes[:n]
    assert len(codes) == n
    got = tg.encode_geometry(codes, 9)
    assert got[0] == profile and got == jg.encode_geometry(codes, 9)
    assert np.array_equal(tg.decode_geometry(got, 9, n), codes)


@pytest.mark.parametrize("profile", [0, 3, 4])
def test_crc_rejects_a_flipped_byte(profile):
    codes, prev = _frames(n=600, seed=20)
    kw = _encode_kw(profile, prev)
    dec_kw = {"prev_codes": prev} if "prev_codes" in kw else {}
    blob = bytearray(tg.encode_geometry(codes, DEPTH, **kw))
    blob[2] ^= 0x40                                   # inside the stored CRC
    for backend in tg.BACKENDS:
        with pytest.raises(ValueError, match="checksum"):
            tg.decode_geometry(bytes(blob), DEPTH, len(codes), backend=backend, **dec_kw)
    with pytest.raises(ValueError, match="checksum"):
        jg.decode_geometry(bytes(blob), DEPTH, len(codes), **dec_kw)


def test_temporal_sections_need_their_reference():
    codes, prev = _frames(n=400, seed=21)
    blob = tg.encode_geometry(codes, DEPTH, prev_codes=prev)
    with pytest.raises(ValueError, match="needs prev_codes"):
        tg.decode_geometry(blob, DEPTH, len(codes))
    # a wrong reference fails the checksum rather than decoding wrong voxels
    with pytest.raises(ValueError):
        tg.decode_geometry(blob, DEPTH, len(codes), prev_codes=codes)


@pytest.mark.parametrize("case", ["too_many", "zero", "count_mismatch", "truncated",
                                  "unknown_profile", "motion_cut"])
def test_header_checks_match_jax(case):
    depth = 4 if case == "too_many" else DEPTH
    codes, prev = _frames(n=300, depth=depth, seed=22)
    blob = tg.encode_geometry(codes, depth)
    args = {
        "too_many": (blob, 4, 8 ** 4 + 1),             # _check_n_voxels
        "zero": (blob, DEPTH, 0),
        "count_mismatch": (blob, DEPTH, len(codes) + 1),
        "truncated": (blob[:3], DEPTH, len(codes)),
        "unknown_profile": (bytes([9]) + blob[1:], DEPTH, len(codes)),
        "motion_cut": (bytes([2]) + blob[1:5] + b"\0", DEPTH, len(codes)),
    }[case]
    for fn in (tg.decode_geometry, jg.decode_geometry):
        with pytest.raises(ValueError):
            fn(*args, prev_codes=prev)
    if case == "too_many":
        with pytest.raises(ValueError, match="exceeds the 8"):
            tg._check_n_voxels(8 ** 4 + 1, 4)
        tg._check_n_voxels(8 ** 4, 4)


def test_positions_helpers_match_jax():
    rng = np.random.default_rng(23)
    _, codes, _ = unique_voxel_cloud(rng, 700, DEPTH)
    pts = morton_decode(torch.as_tensor(codes), DEPTH).numpy()
    shuffled = pts[rng.permutation(len(pts))].astype(np.float64) + 0.25
    assert _equal(tg.codes_from_positions(shuffled, DEPTH),
                  jg.codes_from_positions(shuffled, DEPTH))
    blob = tg.geometry_from_positions(shuffled, DEPTH)
    assert blob == jg.geometry_from_positions(shuffled, DEPTH)
    got = tg.positions_from_geometry(blob, DEPTH, len(codes), device="cpu")
    assert _equal(got, np.asarray(jg.positions_from_geometry(blob, DEPTH, len(codes))))
    assert np.array_equal(got, pts)
    for level in (1, 3, 7):
        assert _equal(tg.positions_from_geometry_lod(blob, DEPTH, len(codes), level,
                                                     device="cpu"),
                      np.asarray(jg.positions_from_geometry_lod(blob, DEPTH, len(codes),
                                                                level)))
    with pytest.raises(ValueError, match="duplicate"):
        tg.codes_from_positions(np.concatenate([shuffled, shuffled[:1]]), DEPTH)


def test_shift_codes_matches_jax():
    codes, _ = _frames(n=500, seed=24)
    for mv in ((0, 0, 0), (1, -2, 3), (300, 0, -300)):
        assert np.array_equal(tg._shift_codes(codes, DEPTH, mv),
                              jg._shift_codes(codes, DEPTH, mv))


def test_exports_match_jax():
    import raht3dgs_tpu.codec as jc
    import raht3dgs_tpu_torch.codec as tc

    names = {"encode_geometry", "decode_geometry", "decode_geometry_lod",
             "geometry_from_positions", "positions_from_geometry",
             "positions_from_geometry_lod"}
    assert names <= set(jc.__all__) and names <= set(tc.__all__)
    assert all(getattr(tc, n) is getattr(tg, n) for n in names)
    with pytest.raises(ValueError, match="backend"):
        tg.encode_geometry(np.arange(4), 2, backend="auto")
