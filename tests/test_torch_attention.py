"""mxnet_tpu_torch.ops.attention against mxnet_tpu.ops.attention.

Same numpy inputs through both packages; tolerance 1e-5 (f32, the two
frameworks round transcendental functions and sums differently).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.serving.generate import model as jmodel
from mxnet_tpu_torch.ops import attention as tatt

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rope_default_positions():
    x = _rand(2, 4, 12, 16)
    want = jatt.rope(jnp.asarray(x), base=10000.0)
    got = tatt.rope(torch.from_numpy(x), base=10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_rope_absolute_positions():
    """Decode-style positions: (slots, 1, 1) absolute indices."""
    x = _rand(3, 4, 1, 16, seed=1)
    pos = np.array([0, 7, 41], np.int32).reshape(3, 1, 1)
    want = jatt.rope(jnp.asarray(x), positions=jnp.asarray(pos))
    got = tatt.rope(torch.from_numpy(x), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_layer_norm_population_variance():
    x = _rand(2, 5, 64, seed=2) * 3 + 1
    g = _rand(64, seed=3)
    b = _rand(64, seed=4)
    want = jmodel._ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tatt.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                          torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_attention(causal):
    q = _rand(2, 4, 8, 16, seed=5)
    k = _rand(2, 2, 12, 16, seed=6)
    v = _rand(2, 2, 12, 16, seed=7)
    want = jatt._grouped_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 2, causal)
    got = tatt._grouped_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 2, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_dot_product_attention_causal_tq_lt_tk():
    q = _rand(1, 2, 4, 8, seed=8)
    k = _rand(1, 2, 9, 8, seed=9)
    v = _rand(1, 2, 9, 8, seed=10)
    want = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True)
    got = tatt.dot_product_attention(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_cached_attention_masks_by_length():
    q = _rand(3, 4, 1, 16, seed=11)
    kc = _rand(3, 2, 10, 16, seed=12)
    vc = _rand(3, 2, 10, 16, seed=13)
    lengths = np.array([0, 4, 9], np.int32)
    want = jatt.cached_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lengths))
    got = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    # stale kv past a row's length has no effect on that row
    kc2 = kc.copy()
    kc2[1, :, 5:] = 100.0
    got2 = tatt.cached_attention(torch.from_numpy(q), torch.from_numpy(kc2),
                                 torch.from_numpy(vc),
                                 torch.from_numpy(lengths))
    assert torch.equal(got2[1], got[1])
