"""The port's Morton codes against the JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.ops import morton as jm
from raht3dgs_tpu_torch.ops import morton as tm

_DT = {torch.int32: np.int32, torch.int64: np.int64}


@pytest.mark.parametrize("depth", [6, 10, 18, 20])
def test_encode_decode_match(rng, depth):
    V = rng.integers(0, 2**depth, size=(3000, 3))
    want = np.asarray(jm.morton_encode(jnp.asarray(V), depth))
    got = tm.morton_encode(torch.as_tensor(V), depth).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    dec_want = np.asarray(jm.morton_decode(jnp.asarray(want), depth))
    dec_got = tm.morton_decode(torch.as_tensor(got), depth).numpy()
    assert np.array_equal(dec_got, dec_want)
    assert np.array_equal(dec_got, V)


@pytest.mark.parametrize("depth", [6, 10, 18, 20])
@pytest.mark.parametrize("n", [1, 1000, 1 << 19])
def test_pad_code_and_dtype_match(depth, n):
    assert tm.internal_payload_bits(depth, n) == jm.internal_payload_bits(depth, n)
    assert _DT[tm.code_dtype(depth, n)] == np.dtype(jm.code_dtype(depth, n))
    slots = np.arange(max(0, n - 5), n)
    want = np.asarray(jm.pad_code(depth, n, jnp.asarray(slots)))
    got = tm.pad_code(depth, n, torch.as_tensor(slots)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_depth_21_is_refused_not_truncated():
    with pytest.raises(NotImplementedError):
        tm.morton_encode(torch.zeros(2, 3, dtype=torch.int64), 21)
    with pytest.raises(NotImplementedError):
        tm.code_dtype(21, 100)
