"""mxnet_tpu_torch flash-attention forward against the Pallas kernel.

The plain version (what the wrapper runs for CPU tensors, and what the
CUDA kernel is held against on the card) is compared with the reference's
Pallas kernel run in interpret mode, as tests/test_consistency.py does.
Tolerance 2e-4 (f32, summation order differs), as there.
"""
import os

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
    assert _build.inputs("flash_attention_fwd") == ["flash_attention_fwd.cu",
                                                    "hopper.cuh"]
    assert _build.inputs("fused_update") == ["fused_update.cu"]


def test_build_key_reads_only_included_headers(tmp_path, monkeypatch):
    """A header edit rebuilds the sources that include it, directly or
    through another header, and no other."""
    (tmp_path / "a.cu").write_text('#include "outer.cuh"\n#include <math.h>\n')
    (tmp_path / "outer.cuh").write_text('  #  include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "b.cu").write_text("// no headers\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build.inputs("a") == ["a.cu", "inner.cuh", "outer.cuh"]
    a, b = _build.lib_path("a"), _build.lib_path("b")
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert _build.lib_path("a") != a and _build.lib_path("b") == b


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
    """The backward's operand plan (which replaced a unit-stride-only
    check): the (B, T, H, D) views attention passes are read in place, a
    strided head dim is copied contiguous with equal values."""
    view = torch.zeros(1, 16, 2, 8).transpose(1, 2)
    strided = torch.arange(2 * 16 * 16, dtype=torch.float32).reshape(
        1, 2, 16, 16)[..., ::2]
    got, strides = tfa.bwd_operands(view, view, view, strided)
    assert all(t is view for t in got[:3])
    assert got[3].is_contiguous() and torch.equal(got[3], strided)
    assert strides == sum((tfa.tensor_map_plan(t)[0] for t in got), ())


# --- the forward kernel's host-side plan -------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_map_plan_of_contiguous_bhtd(dtype):
    """(B, H, T, D) contiguous: packed byte strides of B, H and T, read in
    place."""
    t = torch.zeros(2, 4, 10, 64, dtype=dtype)
    item = t.element_size()
    strides, copy = tfa.tensor_map_plan(t)
    assert strides == (4 * 10 * 64 * item, 10 * 64 * item, 64 * item)
    assert not copy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_map_plan_of_bthd_views(dtype):
    """The (B, T, H, D)-storage views MultiHeadAttention and prefill pass:
    the T stride spans all heads, the H stride one head; no copy."""
    t = torch.zeros(3, 10, 4, 128, dtype=dtype).transpose(1, 2)
    item = t.element_size()
    strides, copy = tfa.tensor_map_plan(t)
    assert strides == (10 * 4 * 128 * item, 128 * item, 4 * 128 * item)
    assert not copy
    got, byte_strides = tfa._in_place(t)
    assert got is t and byte_strides == strides


def test_tensor_map_plan_gives_singleton_dims_packed_strides():
    """A dim of size 1 is never stepped: its stride is the packed one, so
    an odd stride there forces no copy."""
    t = torch.zeros(1, 4, 7, 64)[:, :, 3:4]          # T = 1 inside T = 7
    strides, copy = tfa.tensor_map_plan(t)
    assert strides == (4 * 7 * 256, 7 * 256, 256) and not copy
    odd = torch.zeros(1, 1, 5, 64).as_strided((1, 1, 5, 64), (3, 3, 64, 1))
    assert tfa.tensor_map_plan(odd) == ((5 * 256, 5 * 256, 256), False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_layouts_are_copied_with_equal_values(dtype):
    """Rows whose T stride is no multiple of 16 bytes, a base off a
    16-byte boundary, and a strided head dim each take a contiguous copy,
    whose plan is aligned and whose values are the view's."""
    base = torch.from_numpy(
        np.random.RandomState(5).randn(2, 4, 9, 65).astype(np.float32))
    flat = torch.from_numpy(
        np.random.RandomState(6).randn(2 * 4 * 9 * 64 + 1).astype(np.float32))
    views = {
        "padded_rows": base.to(dtype)[..., :64],
        "shifted_base": flat.to(dtype)[1:].view(2, 4, 9, 64),
        "strided_head_dim": base[..., :64].to(dtype)
        .repeat_interleave(2, -1)[..., ::2],
    }
    for name, view in views.items():
        assert tfa.tensor_map_plan(view)[1], name
        got, byte_strides = tfa._in_place(view)
        assert got is not view and got.is_contiguous(), name
        assert torch.equal(got, view), name
        assert tfa.tensor_map_plan(got) == (byte_strides, False), name
        assert got.data_ptr() % 16 == 0 and all(s % 16 == 0
                                                for s in byte_strides), name


def test_check_kernel_rejects_what_the_kernel_does_not_take():
    """After the plan's copies, the kernels still take only f32 / bf16,
    head dims 64 and 128 and a unit-stride head dim; the forward's grid
    takes ceil(Tq / 128) <= 65535 q-tiles, the backward's
    ceil(max(Tq, Tk) / 64) <= 65535 q- or k-tiles (B * H is on grid x)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 64))
    tfa._check_kernel(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check_kernel(q.double(), k.double(), v.double())
    q32, k32, v32 = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_kernel(q32, k32, v32)
    with pytest.raises(ValueError, match="unit stride"):
        tfa._check_kernel(q, k, torch.zeros(1, 2, 16, 128)[..., ::2])
    wide = torch.zeros(1, 1, 1, 64).expand(1, 65536, 1, 64)
    tfa._check_kernel(wide, wide, wide)
    tfa._check_kernel(wide, wide, wide, backward=True)
    tfa._check_kernel(q, k, v, backward=True)
    most = torch.zeros(1, 1, 1, 64).expand(1, 1, 65535 * 128, 64)
    tfa._check_kernel(most, most, most)
    long = torch.zeros(1, 1, 1, 64).expand(1, 1, 65535 * 128 + 1, 64)
    with pytest.raises(ValueError, match="forward grid"):
        tfa._check_kernel(long, long, long)
    most_bwd = torch.zeros(1, 1, 1, 64).expand(1, 1, 65535 * 64, 64)
    tfa._check_kernel(most_bwd, most_bwd, most_bwd, backward=True)
    long_k = torch.zeros(1, 1, 1, 64).expand(1, 1, 65535 * 64 + 1, 64)
    with pytest.raises(ValueError, match="backward grid"):
        tfa._check_kernel(q[:, :1], long_k, long_k, backward=True)


# --- the forward's ablation variants --------------------------------------------
def test_ablation_variants_edit_the_current_source(monkeypatch):
    """Every variant's edits still find their text exactly once in the
    kernel source, and each edited variant differs from it."""
    from mxnet_tpu_torch.tools import flash_fwd_ablate as ab

    with open(os.path.join(_build.CSRC, "flash_attention_fwd.cu")) as f:
        source = f.read()
    for name, (dtype, edits) in ab.VARIANTS.items():
        assert dtype in ("bfloat16", "float32")
        assert (ab.variant_source(name) == source) == (not edits), name
    monkeypatch.setitem(ab.VARIANTS, "gone", ("float32", [("no such", "")]))
    with pytest.raises(ValueError, match="occurs 0 times"):
        ab.variant_source("gone")


# --- why the bf16 kernel splits P ---------------------------------------------
def test_p_split_reconstructs_p_to_two_to_the_minus_16():
    from mxnet_tpu_torch.tools import flash_p_spread as fps

    p = torch.from_numpy(np.random.RandomState(7).rand(4096)
                         .astype(np.float32))
    hi, lo = fps.split_bf16(p)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rel = ((hi.float() + lo.float() - p).abs() / p).max()
    assert rel <= 2.0 ** -16


@pytest.mark.parametrize("case", ["mha_causal", "gqa_causal_tq_lt_tk",
                                  "gqa"])
def test_kernel_arithmetic_with_split_p_matches_pallas_interpret(case):
    """The bf16 kernel's arithmetic (128-key tiles, exp2 domain, P split
    into hi + lo bf16) against the reference's Pallas kernel in interpret
    mode on the same bf16 inputs, at chip_smoke.py's bf16 gate."""
    from mxnet_tpu_torch.tools import flash_p_spread as fps

    b, h, hkv, tq, tk, d, causal = CASES[case]
    q, k, v = (a.astype(jnp.bfloat16) for a in _inputs(b, h, hkv, tq, tk, d))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, interpret=True)
    q, k, v = (torch.from_numpy(a.astype(np.float32)).bfloat16()
               for a in (q, k, v))
    got = fps.kernel_arithmetic(q, k, v, causal, split=True, block=8)
    want = torch.from_numpy(np.asarray(want, np.float32))
    assert fps.gate_ratio(got, want) <= 1.0


def test_split_p_stays_well_inside_the_gate_where_single_p_nears_it():
    """At a causal shape with short rows, one bf16 P comes near the gate
    against the plain version; the split P stays below half of it."""
    from mxnet_tpu_torch.tools import flash_p_spread as fps

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 128),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(3))
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    split = fps.gate_ratio(fps.kernel_arithmetic(q, k, v, True, True), want)
    single = fps.gate_ratio(fps.kernel_arithmetic(q, k, v, True, False),
                            want)
    assert split < 0.5 and split < single


# --- why the bf16 backward splits P and dS ------------------------------------
# (B, H, Hkv, Tq, Tk, D, causal): causal and full, GQA and MHA, ragged
# Tq < Tk (neither a multiple of the kernels' 64-row tiles), D 64 and 128
BWD_SPLIT_CASES = {
    "gqa_causal_ragged_d64": (1, 4, 2, 80, 192, 64, True),
    "mha_causal_d128": (1, 2, 2, 128, 128, 128, True),
    "gqa_full_ragged_d128": (1, 4, 2, 40, 100, 128, False),
    "mha_full_d64": (2, 2, 2, 64, 64, 64, False),
}


@pytest.mark.parametrize("case", sorted(BWD_SPLIT_CASES))
def test_bwd_kernel_arithmetic_with_split_matches_pallas_fa_backward(case):
    """The bf16 backward kernels' arithmetic (64-row tiles, P in the exp2
    domain, P and dS split into hi + lo bf16) against the reference's
    _fa_backward (its dQ and dK/dV kernels in interpret mode) on the same
    bf16 q/k/v/dO and the reference forward's o and lse, within
    chip_smoke.py's bf16 backward gate (flash_bwd_spread.GATE)."""
    from mxnet_tpu_torch.tools import flash_bwd_spread as fbs

    b, h, hkv, tq, tk, d, causal = BWD_SPLIT_CASES[case]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    q, k, v = (a.astype(jnp.bfloat16)
               for a in _inputs(b, h, hkv, tq, tk, d, seed=8))
    do = np.random.RandomState(9).randn(b, h, tq, d).astype(jnp.bfloat16)
    q3, do3 = (jnp.asarray(a.reshape(b * hkv, g, tq, d)) for a in (q, do))
    k3, v3 = (jnp.asarray(a.reshape(b * hkv, tk, d)) for a in (k, v))
    o3, lse3 = jfa._fa_forward(q3, k3, v3, causal, scale, interpret=True,
                               with_lse=True)
    want = jfa._fa_backward(q3, k3, v3, o3, lse3, do3, causal, scale,
                            interpret=True)
    as_torch = (lambda a, shape: torch.from_numpy(
        np.array(a, np.float32).reshape(shape)))
    qt, dot = (as_torch(a, (b, h, tq, d)).bfloat16() for a in (q, do))
    kt, vt = (as_torch(a, (b, hkv, tk, d)).bfloat16() for a in (k, v))
    got = fbs.kernel_arithmetic(
        qt, kt, vt, as_torch(o3, (b, h, tq, d)).bfloat16(),
        as_torch(lse3, (b, h, tq)), dot, causal, True, True, scale)
    shapes = ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    ratios = fbs.gate_ratios(
        got, [as_torch(w, shape) for w, shape in zip(want, shapes)])
    assert max(ratios.values()) <= 1.0, ratios


def test_bwd_split_stays_well_inside_the_gate_where_single_bf16_fails():
    """At a causal shape with short rows, one bf16 P (into dV) and one bf16
    dS (into dQ, dK) fail the bf16 gate against the plain version; split
    into hi + lo, every gradient stays below half of it."""
    from mxnet_tpu_torch.tools import flash_bwd_spread as fbs

    ratios = fbs.shape_ratios((1, 16, 4, 128, 128, 128, True),
                              np.random.default_rng(0))
    assert max(ratios["single"].values()) > 1.0, ratios
    assert ratios["split_p"]["dv"] < 0.5 < ratios["single"]["dv"], ratios
    assert max(ratios["split"].values()) < 0.5, ratios


def test_bwd_split_operand_reconstructs_to_two_to_the_minus_16():
    from mxnet_tpu_torch.tools import flash_bwd_spread as fbs

    x = torch.from_numpy(np.random.RandomState(10).randn(4096)
                         .astype(np.float32))
    rel = ((fbs.bf16_operand(x, True) - x).abs() / x.abs()).max()
    assert rel <= 2.0 ** -16
    single = ((fbs.bf16_operand(x, False) - x).abs() / x.abs()).max()
    assert 2.0 ** -10 < single <= 2.0 ** -8


def test_bwd_operands_copy_a_misaligned_do_with_equal_values():
    """dO from autograd may arrive in any layout: one whose base is off a
    16-byte boundary or whose rows are padded is copied (aligned, equal
    values) while q/k/v in the (B, T, H, D) views are read in place."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 64).astype(np.float32))
               .bfloat16().transpose(1, 2) for _ in range(3))
    flat = torch.from_numpy(rng.randn(1 * 2 * 8 * 64 + 1).astype(np.float32))
    padded = torch.from_numpy(rng.randn(1, 2, 8, 65).astype(np.float32))
    for do in (flat.bfloat16()[1:].view(1, 2, 8, 64),
               padded.bfloat16()[..., :64]):
        assert tfa.tensor_map_plan(do)[1]
        got, strides = tfa.bwd_operands(q, k, v, do)
        assert all(a is b for a, b in zip(got[:3], (q, k, v)))
        assert got[3] is not do and torch.equal(got[3], do)
        assert tfa.tensor_map_plan(got[3])[1] is False
        assert got[3].data_ptr() % 16 == 0
        assert strides[9:] == tfa.tensor_map_plan(got[3])[0]


@pytest.mark.parametrize("case", ["gqa_tq_lt_tk", "mqa"])
def test_lse_autograd_matches_pallas_flash_with_lse(case):
    """FlashAttentionLse (plain forward and backward on the CPU) against
    the reference's ``_flash_with_lse`` in interpret mode: O, lse and the
    vector-Jacobian product at seeded cotangents on both outputs (the
    lse's folded into D := rowsum(dO * O) - g_lse)."""
    import jax

    b, h, hkv, tq, tk, d, causal = BWD_CASES[case]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    q, k, v = _inputs(b, h, hkv, tq, tk, d, seed=5)
    rng = np.random.RandomState(6)
    do = rng.randn(b, h, tq, d).astype(np.float32)
    dl = rng.randn(b, h, tq).astype(np.float32)
    q4 = jnp.asarray(q.reshape(b * hkv, g, tq, d))
    k3, v3 = (jnp.asarray(a.reshape(b * hkv, tk, d)) for a in (k, v))
    (o4, lse4), vjp = jax.vjp(
        lambda q_, k_, v_: jfa._flash_with_lse(q_, k_, v_, causal, scale,
                                               True), q4, k3, v3)
    want = vjp((jnp.asarray(do.reshape(b * hkv, g, tq, d)),
                jnp.asarray(dl.reshape(b * hkv, g, 1, tq))))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.FlashAttentionLse.apply(tq_, tk_, tv_, causal, scale)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(o4).reshape(b, h, tq, d), atol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(),
                               np.asarray(lse4).reshape(b, h, tq), atol=TOL)
    torch.autograd.backward([out, lse], [torch.from_numpy(do),
                                         torch.from_numpy(dl)])
    shapes = ((b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    for name, t, ref, shape in zip("qkv", (tq_.grad, tk_.grad, tv_.grad),
                                   want, shapes):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref).reshape(shape),
                                   err_msg="d" + name, **BWD_TOL)
    # the lse's cotangent moves the gradients: it is not dropped
    plain = tfa.flash_attention_bwd_plain(
        *(t.detach() for t in (tq_, tk_, tv_, out, lse)),
        torch.from_numpy(do), causal, scale)
    assert not torch.allclose(plain[0], tq_.grad)


def test_zero_lse_cotangent_changes_nothing_bit_for_bit():
    """A zero (or absent) lse cotangent gives FlashAttention's gradients
    bit for bit, through the autograd function and the plain backward."""
    b, h, hkv, tq, tk, d, causal = BWD_CASES["gqa_tq_lt_tk"]
    q, k, v = _inputs(b, h, hkv, tq, tk, d, seed=7)
    do = torch.from_numpy(
        np.random.RandomState(8).randn(b, h, tq, d).astype(np.float32))
    grads = []
    for use_lse in (False, True):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if use_lse:
            out, lse = tfa.FlashAttentionLse.apply(*ts, causal, None)
            torch.autograd.backward([out, lse], [do, torch.zeros_like(lse)])
        else:
            out = tfa.FlashAttention.apply(*ts, causal, None)
            out.backward(do)
        grads.append([t.grad for t in ts])
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_attention_plain(qt, kt, vt, causal=causal,
                                       return_lse=True)
    none = tfa.flash_attention_bwd(qt, kt, vt, o, lse, do, causal)
    zero = tfa.flash_attention_bwd(qt, kt, vt, o, lse, do, causal,
                                   g_lse=torch.zeros_like(lse))
    for a, b_ in zip(none, zero):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="g_lse"):
        tfa.flash_attention_bwd(qt, kt, vt, o, lse, do, causal,
                                g_lse=lse[:, :, :2])
