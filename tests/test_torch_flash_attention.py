"""mxnet_tpu_torch flash-attention forward against the Pallas kernel.

The plain version (what the wrapper runs for CPU tensors, and what the
CUDA kernel is held against on the card) is compared with the reference's
Pallas kernel run in interpret mode, as tests/test_consistency.py does.
Tolerance 2e-4 (f32, summation order differs), as there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa

TOL = 2e-4

# (B, H, Hkv, Tq, Tk, D, causal): MHA and GQA, causal and not, tq < tk
CASES = {
    "mha": (2, 4, 4, 16, 16, 8, False),
    "mha_causal": (2, 4, 4, 16, 16, 8, True),
    "gqa": (1, 4, 2, 32, 32, 8, False),
    "gqa_causal": (1, 4, 2, 32, 32, 8, True),
    "gqa_causal_tq_lt_tk": (1, 4, 2, 16, 32, 8, True),
}


def _inputs(b, h, hkv, tq, tk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, hkv, tk, d).astype(np.float32)
    v = rng.randn(b, hkv, tk, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    b, h, hkv, tq, tk, d, causal = CASES[case]
    q, k, v = _inputs(b, h, hkv, tq, tk, d)
    assert jfa.kernel_qualifies(tq, tk, d, compiled=False, causal=causal)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True)
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", ["mha_causal", "gqa_causal_tq_lt_tk"])
def test_plain_bf16_matches_pallas_interpret(case):
    """bf16 in and out, f32 inside on both sides: the outputs differ by at
    most one bf16 ulp (relative 2**-7), from f32 summation order."""
    b, h, hkv, tq, tk, d, causal = CASES[case]
    q, k, v = (a.astype(jnp.bfloat16) for a in _inputs(b, h, hkv, tq, tk, d))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True)
    q, k, v = (torch.from_numpy(a.astype(np.float32)).bfloat16()
               for a in (q, k, v))
    got = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5, rtol=2 ** -7)


@pytest.mark.parametrize("case", ["mha_causal", "gqa_causal_tq_lt_tk",
                                  "gqa"])
def test_plain_lse_matches_pallas_interpret(case):
    b, h, hkv, tq, tk, d, causal = CASES[case]
    q, k, v = _inputs(b, h, hkv, tq, tk, d, seed=1)
    g = h // hkv
    scale = 1.0 / d ** 0.5
    o3, lse3 = jfa._fa_forward(
        jnp.asarray(q.reshape(b * hkv, g, tq, d)),
        jnp.asarray(k.reshape(b * hkv, tk, d)),
        jnp.asarray(v.reshape(b * hkv, tk, d)), causal, scale,
        interpret=True, with_lse=True)
    out, lse = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, tq)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(o3).reshape(b, h, tq, d),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse3).reshape(b, h, tq),
                               atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 32, 8))
    before = tfa.flash_attention.launches
    out, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True,
                                             return_lse=True)
    assert tfa.flash_attention.launches == before
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_wrapper_rejects_what_no_path_takes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 16, 16, 8))
    with pytest.raises(ValueError, match="not divisible"):
        tfa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 16, 8))
    with pytest.raises(ValueError, match="tq <= tk"):
        tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(TypeError, match="dtypes differ"):
        tfa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="no path"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_checks_dtype_head_dim_and_stride():
    """What a CUDA tensor must satisfy before the kernel launches (checked
    here on CPU tensors: the checks read only shapes, types, strides)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 128))
    tfa._check_kernel(q, k, v)
    tfa._check_kernel(q.bfloat16(), k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check_kernel(q.half(), k.half(), v.half())
    q96, k96, v96 = (torch.from_numpy(a)
                     for a in _inputs(1, 4, 2, 16, 16, 96))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_kernel(q96, k96, v96)
    strided = torch.zeros(1, 2, 16, 256)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        tfa._check_kernel(q, strided, v)
    # a transposed view with unit inner stride is taken as is (no copy)
    vt = torch.zeros(1, 16, 2, 128).transpose(1, 2)
    tfa._check_kernel(q, k, vt)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.nvcc()


def test_build_key_follows_sources():
    names = _build.sources()
    assert "flash_attention_fwd" in names
    p = _build.lib_path("flash_attention_fwd")
    assert p == _build.lib_path("flash_attention_fwd")
    assert p.startswith(_build.BUILD_DIR) and p.endswith(".so")


# --- backward -----------------------------------------------------------------
# (B, H, Hkv, Tq, Tk, D, causal) from tests/test_consistency.py:388-474:
# multi-block causal, GQA with tq < tk, MQA, and a causal cross length
BWD_CASES = {
    "multiblock_causal": (1, 1, 1, 512, 512, 8, True),
    "multiblock_full": (1, 1, 1, 512, 512, 8, False),
    "gqa_tq_lt_tk": (2, 4, 2, 256, 512, 8, True),
    "mqa": (2, 8, 1, 256, 256, 8, False),
    "cross_length": (1, 2, 2, 128, 256, 8, True),
}
# as the reference's own gradient tests
BWD_TOL = {"rtol": 2e-3, "atol": 5e-4}


def _pallas_grads(q, k, v, causal):
    import jax

    return jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, causal=causal, interpret=True) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_autograd_flash_matches_pallas_grad(case):
    """FlashAttention (plain forward + plain backward on the CPU) against
    jax.grad of the Pallas kernel in interpret mode, d/dq,k,v sum(O**2);
    dk/dv come back at the narrow kv width."""
    b, h, hkv, tq, tk, d, causal = BWD_CASES[case]
    q, k, v = _inputs(b, h, hkv, tq, tk, d, seed=2)
    assert jfa.kernel_qualifies(tq, tk, d, compiled=False, causal=causal)
    want = _pallas_grads(q, k, v, causal)
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.FlashAttention.apply(tq_, tk_, tv_, causal, None)
    (out ** 2).sum().backward()
    assert tk_.grad.shape == (b, hkv, tk, d)
    for name, got, ref in zip("qkv", (tq_.grad, tk_.grad, tv_.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg="d" + name, **BWD_TOL)


@pytest.mark.parametrize("case", ["gqa_tq_lt_tk", "mqa"])
def test_bwd_plain_matches_pallas_fa_backward(case):
    """flash_attention_bwd_plain against the reference's _fa_backward
    (its dQ and dK/dV kernels, interpret mode) on the same o, lse, dO."""
    b, h, hkv, tq, tk, d, causal = BWD_CASES[case]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    q, k, v = _inputs(b, h, hkv, tq, tk, d, seed=3)
    do = np.random.RandomState(4).randn(b, h, tq, d).astype(np.float32)
    q3, do3 = (jnp.asarray(a.reshape(b * hkv, g, tq, d)) for a in (q, do))
    k3, v3 = (jnp.asarray(a.reshape(b * hkv, tk, d)) for a in (k, v))
    o3, lse3 = jfa._fa_forward(q3, k3, v3, causal, scale, interpret=True,
                               with_lse=True)
    want = jfa._fa_backward(q3, k3, v3, o3, lse3, do3, causal, scale,
                            interpret=True)
    got = tfa.flash_attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(o3).reshape(b, h, tq, d)),
        torch.from_numpy(np.array(lse3).reshape(b, h, tq)),
        torch.from_numpy(do), causal, scale)
    shapes = ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    for name, t, ref, shape in zip("qkv", got, want, shapes):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref).reshape(shape),
                                   err_msg="d" + name, **BWD_TOL)


def test_bwd_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 32, 8))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    do = torch.ones_like(o)
    counters = (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert [c.launches for c in counters] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bwd_wrapper_rejects_what_no_path_takes():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 32, 8))
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="shaped like q"):
        tfa.flash_attention_bwd(q, k, v, o, lse[:, :, :4], o)
    with pytest.raises(TypeError, match="differ"):
        tfa.flash_attention_bwd(q, k, v, o, lse, o.double())
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention_bwd(q, k, v, o, lse, o.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        tfa.flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, lse, o)))


def test_unit_inner_keeps_views_and_copies_strided_head_dims():
    view = torch.zeros(1, 16, 2, 8).transpose(1, 2)
    assert tfa._unit_inner(view) is view
    strided = torch.zeros(1, 2, 16, 16)[..., ::2]
    assert tfa._unit_inner(strided).is_contiguous()
