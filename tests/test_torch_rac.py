"""The port's RAC coder: byte-identical streams to the JAX package's.

Every fixture goes through the port's native library, the port's plain
twin (``backend="python"``) and the JAX package's coder; the three streams
must be equal byte for byte, decode to the input in both packages, and
prefix decodes (``n < n_total``) must give the JAX package's symbols.
"""

import os

import numpy as np
import pytest

from raht3dgs_tpu.codec import rac as jr
from raht3dgs_tpu_torch.codec import _native
from raht3dgs_tpu_torch.codec import rac as tr


def _patterns(rng):
    lap = lambda n, s: np.round(rng.laplace(0, s, n)).astype(np.int32)
    return {
        "empty": np.array([], np.int32),
        "one": np.array([-7], np.int32),
        "int32_extremes": np.array([2**31 - 1, -2**31, 0, -2**31 + 1, 1, -1] * 20,
                                   np.int32),
        "long_zero_runs": np.array([0] * 3000 + [5] + [0] * 4000 + [-2] + [0] * 100,
                                   np.int32),
        "laplace_small": lap(2000, 0.7),
        "laplace_wide": lap(5000, 40.0),
        "rice_escape": np.array([0, 3, 2**24, -(2**20), 9] * 50, np.int32),
        "powers": np.array([(1 << i) - 1 for i in range(31)] * 4, np.int32),
    }


PATTERNS = list(_patterns(np.random.default_rng(0)))


@pytest.mark.parametrize("name", PATTERNS)
def test_single_stream_matches_jax(name):
    v = _patterns(np.random.default_rng(1))[name]
    got, _ = tr.rac_encode(v)
    assert got == jr.rac_encode(v)[0]
    assert got == tr.rac_encode(v, backend="python")[0]
    for backend in tr.BACKENDS:
        dec, _ = tr.rac_decode(got, len(v), backend=backend)
        assert np.array_equal(dec, v)
    assert np.array_equal(jr.rac_decode(got, len(v))[0], v)


@pytest.mark.parametrize("name", ["laplace_small", "laplace_wide", "long_zero_runs",
                                  "int32_extremes"])
def test_cond_profile_matches_jax(name):
    rng = np.random.default_rng(2)
    v = _patterns(rng)[name]
    cond = rng.random(len(v)) < 0.4
    got, _ = tr.rac_encode(v, cond=cond)
    assert got[0] == 1 and tr.rac_stream_profile(got) == 1
    assert got == jr.rac_encode(v, cond=cond)[0]
    assert got == tr.rac_encode(v, backend="python", cond=cond)[0]
    for backend in tr.BACKENDS:
        assert np.array_equal(tr.rac_decode(got, len(v), backend=backend, cond=cond)[0], v)
    # the profile byte names the context set: decoding without cond refuses
    with pytest.raises(ValueError):
        tr.rac_decode(got, len(v))
    with pytest.raises(ValueError, match="cond has"):
        tr.rac_encode(v, cond=cond[:-1])


@pytest.mark.parametrize("chunk", [1, 333, 1000, 65536])
def test_chunked_matches_jax(chunk):
    rng = np.random.default_rng(3)
    v = np.round(rng.laplace(0, 3.0, 2500)).astype(np.int32)
    cond = rng.random(len(v)) < 0.5
    for c in (None, cond):
        got, _ = tr.rac_encode_chunked(v, chunk, cond=c)
        assert got == jr.rac_encode_chunked(v, chunk, cond=c)[0]
        assert got == tr.rac_encode_chunked(v, chunk, cond=c, backend="python")[0]
        assert np.array_equal(tr.rac_decode_chunked(got, len(v), cond=c)[0], v)
        assert tr.rac_stream_profile(got, chunk) == (0 if c is None else 1)


@pytest.mark.parametrize("chunk", [0, 700])
@pytest.mark.parametrize("n", [1, 350, 699, 1999])
def test_prefix_decodes_match_jax(chunk, n):
    v = np.round(np.random.default_rng(4).laplace(0, 5.0, 2000)).astype(np.int32)
    if chunk:
        blob, _ = tr.rac_encode_chunked(v, chunk)
        got, _ = tr.rac_decode_chunked(blob, n, len(v))
        want, _ = jr.rac_decode_chunked(blob, n, len(v))
    else:
        blob, _ = tr.rac_encode(v)
        got, _ = tr.rac_decode(blob, n, len(v))
        want, _ = jr.rac_decode(blob, n, len(v))
        assert np.array_equal(tr.rac_decode(blob, n, len(v), backend="python")[0], want)
    assert np.array_equal(got, want) and np.array_equal(got, v[:n])


@pytest.mark.parametrize("chunk", [0, 512])
def test_channels_batch_equals_per_stream_and_jax(chunk):
    rng = np.random.default_rng(5)
    q = np.ascontiguousarray(np.round(rng.laplace(0, 2.0, (3, 1500))).astype(np.int32))
    n = 1400
    batch, _ = tr.rac_encode_channels(q, channel_major=True, chunk=chunk, n=n)
    single, _ = tr.rac_encode_channels(q, channel_major=True, chunk=chunk, n=n, batch=False)
    assert batch == single == jr.rac_encode_channels(q, channel_major=True, chunk=chunk,
                                                     n=n)[0]
    # sample-major input gives the same streams
    assert tr.rac_encode_channels(q[:, :n].T.copy(), chunk=chunk)[0] == batch
    for b in (True, False):
        out = np.zeros((3, 1500), np.int32)
        tr.rac_decode_channels(batch, n, out, chunk=chunk, batch=b)
        assert np.array_equal(out[:, :n], q[:, :n]) and not out[:, n:].any()
    # a prefix of every channel, as a progressive decode asks for it
    k = 300
    got = np.zeros((3, 1500), np.int32)
    want = np.zeros((3, 1500), np.int32)
    tr.rac_decode_channels(batch, k, got, chunk=chunk, n_total=n)
    jr.rac_decode_channels(batch, k, want, chunk=chunk, n_total=n)
    assert np.array_equal(got, want) and np.array_equal(got[:, :k], q[:, :k])


@pytest.mark.parametrize("chunk", [0, 400])
def test_corrupt_and_truncated_streams_raise(chunk):
    v = np.round(np.random.default_rng(6).laplace(0, 4.0, 1000)).astype(np.int32)
    blob = tr.rac_encode_chunked(v, chunk)[0] if chunk else tr.rac_encode(v)[0]
    dec = ((lambda b, n: tr.rac_decode_chunked(b, n)) if chunk
           else (lambda b, n: tr.rac_decode(b, n)))
    bad_profile = bytearray(blob)
    bad_profile[8 + 4 * 3 if chunk else 0] = 7
    for broken in (blob[:3], bytes(bad_profile), b""):
        with pytest.raises(ValueError):
            dec(broken, len(v))
    if chunk:  # a length table that runs past the buffer
        with pytest.raises(ValueError, match="truncated"):
            dec(blob[:-5], len(v))
        with pytest.raises(ValueError, match="cover"):
            dec(blob, 1201)
    with pytest.raises(ValueError):
        tr.rac_decode(blob, 10, 5)
    with pytest.raises(ValueError, match="backend"):
        tr.rac_encode(v, backend="auto")
    # the batch decoder checks every stream as well
    with pytest.raises(ValueError):
        tr.rac_decode_channels([tr.rac_encode(v)[0], bytes([9]) + bytes(8)], len(v),
                               np.zeros((2, len(v)), np.int32))


def test_stream_profile_reads_the_leading_byte():
    v = np.arange(-50, 50, dtype=np.int32)
    assert tr.rac_stream_profile(tr.rac_encode(v)[0]) == 0
    assert tr.rac_stream_profile(b"") == -1
    assert tr.rac_stream_profile(b"\x01\x02", chunk=64) == -1   # a cut header


def test_library_builds_into_port_build_dir_with_header_dep():
    assert tr.NATIVE.load() is not None
    assert os.path.dirname(tr.NATIVE.lib_path).endswith(
        os.path.join("raht3dgs_tpu_torch", "_build"))
    assert [os.path.basename(d) for d in tr.NATIVE.deps] == ["range_coder.h"]


def test_native_lib_is_stale_when_a_header_changes(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    src, head = tmp_path / "a.cpp", tmp_path / "a.h"
    src.write_text('#include "a.h"\n')
    head.write_text("\n")
    lib = _native.NativeLib(str(src), "liba.so", lambda _: None,
                            _native.gxx_command, deps=(str(head),))
    assert lib._stale()                        # never built
    (tmp_path / "liba.so").write_bytes(b"")
    os.utime(src, (1000, 1000))
    os.utime(head, (1000, 1000))
    os.utime(tmp_path / "liba.so", (2000, 2000))
    assert not lib._stale()
    os.utime(head, (3000, 3000))               # the header edited after the build
    assert lib._stale()
    os.utime(head, (1000, 1000))
    os.utime(src, (3000, 3000))                # and the source itself
    assert lib._stale()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    lib = _native.NativeLib(str(src), "libbroken.so", lambda _: None, _native.gxx_command)
    with pytest.raises(RuntimeError, match="failed"):
        lib.load()
