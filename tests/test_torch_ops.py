"""The port's colour, quantizer and order ops against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raht3dgs_tpu.ops import color as jc
from raht3dgs_tpu.ops import quantize as jq
from raht3dgs_tpu.ops import reorder as jo
from raht3dgs_tpu_torch.ops import color as tc
from raht3dgs_tpu_torch.ops import quantize as tq
from raht3dgs_tpu_torch.ops import reorder as to


def test_color_transforms_match(rng):
    rgb = rng.integers(0, 256, size=(2000, 3)).astype(np.float64)
    want = np.asarray(jc.rgb_to_yuv(jnp.asarray(rgb)))
    got = tc.rgb_to_yuv(rgb, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)
    back = tc.yuv_to_rgb(torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(back, np.asarray(jc.yuv_to_rgb(jnp.asarray(want))),
                               rtol=0, atol=1e-9)
    assert np.array_equal(tc.rgb_to_yuv_parity(rgb), jc.rgb_to_yuv_parity(rgb))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantizers_match(rng, dtype):
    x = (rng.normal(scale=40, size=(5000, 3))).astype(dtype)
    x[:50] = np.round(x[:50]) + 0.5  # exact ties
    steps = np.array([1.0, 4.0, 16.0], dtype=dtype)
    xt, st = torch.as_tensor(x), torch.as_tensor(steps)
    assert np.array_equal(tq.quantize(xt, st).numpy(),
                          np.asarray(jq.quantize(jnp.asarray(x), jnp.asarray(steps))))
    f = np.asarray(0.3, dtype)
    assert np.array_equal(
        tq.quantize_deadzone(xt, st, torch.as_tensor(f)).numpy(),
        np.asarray(jq.quantize_deadzone(jnp.asarray(x), jnp.asarray(steps), f)))
    q = tq.quantize(xt, st)
    dt = torch.float64 if dtype == np.float64 else torch.float32
    np.testing.assert_array_equal(
        tq.dequantize(q, st, dtype=dt).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(q.numpy()), jnp.asarray(steps), dtype=dtype)))
    d = np.asarray(0.12, dtype)
    np.testing.assert_array_equal(
        tq.dequantize_biased(q, st, torch.as_tensor(d), dtype=dt).numpy(),
        np.asarray(jq.dequantize_biased(jnp.asarray(q.numpy()), jnp.asarray(steps), d,
                                        dtype=dtype)))
    assert np.array_equal(tq.channel_steps(56, 2.0, {"opacity": 0.5}),
                          jq.channel_steps(56, 2.0, {"opacity": 0.5}))


def test_orders_match(rng):
    drop = rng.integers(0, 31, size=4000).astype(np.int32)
    drop[0] = 0
    assert np.array_equal(to.ragft_order(torch.as_tensor(drop)).numpy(),
                          np.asarray(jo.ragft_order(jnp.asarray(drop))))
    w = rng.integers(0, 6, size=4000).astype(np.float64)  # many ties
    assert np.array_equal(to.weight_descending_order(torch.as_tensor(w)).numpy(),
                          np.asarray(jo.weight_descending_order(jnp.asarray(w))))
    perm = rng.permutation(4000).astype(np.int32)
    assert np.array_equal(to.inverse_permutation(torch.as_tensor(perm)).numpy(),
                          np.asarray(jo.inverse_permutation(jnp.asarray(perm))))
    assert to.ORDER_MODES == jo.ORDER_MODES


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ieee_sqrt_is_correctly_rounded_on_cpu(rng, dtype):
    from raht3dgs_tpu_torch.ops.raht import ieee_sqrt

    x = rng.uniform(0, 1e6, size=200_000).astype(dtype)
    got = ieee_sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == x.dtype
    assert np.array_equal(got, np.sqrt(x))
    assert float(ieee_sqrt(torch.tensor(16.0, dtype=torch.float64))) == 4.0
