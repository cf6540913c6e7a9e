"""mxnet_tpu_torch.serving.generate against mxnet_tpu.serving.generate.

The same numpy checkpoint goes into both packages (small LM: L=2, d=64,
H=4, Hkv=2, Dh=16, F=128, V=64). Prefill, one teacher-forced decode step
and admit are compared at tolerance 1e-4 (f32; the frameworks order sums
differently). The scheduler's greedy token streams must equal the JAX
scheduler's, and a stream's tokens must not depend on which streams share
the batch.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.serving import generate as tgen

V, D, L, F, H, HKV = 64, 64, 2, 128, 4, 2
TOL = 1e-4
PROMPTS = [[3, 7, 1], [5, 9, 2, 8, 8, 1, 4], [11], [60, 2, 33, 4, 5, 6],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]]


def _lm_params(seed=0):
    """Random weights under the models/transformer.py naming."""
    rng = np.random.RandomState(seed)
    dkv = D // H * HKV
    p = {"embed_weight": rng.randn(V, D).astype(np.float32)}
    for i in range(L):
        pre = "layer%d" % i
        p[pre + "_ln1_gamma"] = 1 + 0.1 * rng.randn(D).astype(np.float32)
        p[pre + "_ln1_beta"] = 0.1 * rng.randn(D).astype(np.float32)
        for name, shape in (("_q_weight", (D, D)), ("_k_weight", (dkv, D)),
                            ("_v_weight", (dkv, D)), ("_o_weight", (D, D)),
                            ("_ffn1_weight", (F, D)),
                            ("_ffn2_weight", (D, F))):
            p[pre + name] = (rng.randn(*shape) / np.sqrt(shape[1])) \
                .astype(np.float32)
        p[pre + "_ln2_gamma"] = np.ones(D, np.float32)
        p[pre + "_ln2_beta"] = np.zeros(D, np.float32)
        p[pre + "_ffn1_bias"] = 0.1 * rng.randn(F).astype(np.float32)
        p[pre + "_ffn2_bias"] = 0.1 * rng.randn(D).astype(np.float32)
    p["lnf_gamma"] = np.ones(D, np.float32)
    p["lnf_beta"] = np.zeros(D, np.float32)
    p["pred_weight"] = (rng.randn(V, D) / np.sqrt(D)).astype(np.float32)
    p["pred_bias"] = 0.1 * rng.randn(V).astype(np.float32)
    return p


def _models(seed=0):
    params = _lm_params(seed)
    jm = jgen.DecodeModel.from_arg_params(
        params, jgen.DecodeSpec(num_heads=H, num_kv_heads=HKV))
    tm = tgen.DecodeModel.from_arg_params(
        params, tgen.DecodeSpec(num_heads=H, num_kv_heads=HKV),
        device="cpu")
    return jm, tm


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_params_from_numpy_accepts_both_forms():
    jm, _ = _models()
    ckpt = _lm_params()
    a = tgen.params_from_numpy(ckpt, device="cpu")
    b = tgen.params_from_numpy({k: np.asarray(v)
                                for k, v in jm.params.items()}, "cpu")
    assert sorted(a) == sorted(b) == sorted(jm.params)
    for k in a:
        assert a[k].shape == tuple(jm.params[k].shape)
        assert torch.equal(a[k], b[k]), k
    half = tgen.params_from_numpy(ckpt, "cpu", dtype="bfloat16")
    assert half["wq"].dtype == torch.bfloat16
    with pytest.raises(ServingError, match="lack"):
        tgen.params_from_numpy({"wq": a["wq"].numpy()}, "cpu")


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_kv_match_jax(kv_dtype):
    jm, tm = _models()
    bucket, cap, n = 16, 24, 11
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.arange(n) * 5 % V
    jl, jk, jv = jax.jit(jm.build_prefill(bucket, cap, kv_dtype))(
        jm.params, jnp.asarray(toks), jnp.asarray([n], jnp.int32))
    tl, tk, tv = tm.build_prefill(bucket, cap, kv_dtype)(
        tm.params, torch.from_numpy(toks), torch.tensor([n]))
    assert tk.shape == tuple(jk.shape) == tm.kv_slab_shape(1, cap)
    assert tk.dtype == tgen.model.KV_SLAB_DTYPES[kv_dtype]
    tol = TOL if kv_dtype == "float32" else 1e-2   # bf16 storage rounding
    _close(tl, jl)
    _close(tk, np.asarray(jk, np.float32), tol)
    _close(tv, np.asarray(jv, np.float32), tol)


def test_decode_step_and_admit_match_jax():
    """Admit a prefilled prompt into slot 1, then one teacher-forced step
    over all 3 slots (slots 0 and 2 inactive at length 0)."""
    jm, tm = _models()
    slots, cap, bucket = 3, 24, 8
    prompt = [4, 8, 15, 16, 23]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    n = np.array([len(prompt)], np.int32)
    _, jk_new, jv_new = jax.jit(jm.build_prefill(bucket, cap))(
        jm.params, jnp.asarray(toks), jnp.asarray(n))
    _, tk_new, tv_new = tm.build_prefill(bucket, cap)(
        tm.params, torch.from_numpy(toks), torch.from_numpy(n))
    shape = tm.kv_slab_shape(slots, cap)
    jk, jv = jm.build_admit(slots, cap)(
        jnp.zeros(shape), jnp.zeros(shape), jk_new, jv_new,
        jnp.asarray(1, jnp.int32))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    assert tm.build_admit(slots, cap)(tk, tv, tk_new, tv_new, 1) is None
    _close(tk, jk)
    _close(tv, jv)
    assert not tk[:, 0].any() and not tk[:, 2].any()
    lengths = np.array([0, len(prompt), 0], np.int32)
    tokens = np.array([0, 42, 0], np.int32)
    jlog, jk2, jv2 = jax.jit(jm.build_decode(slots, cap))(
        jm.params, jk, jv, jnp.asarray(lengths), jnp.asarray(tokens))
    tlog = tm.build_decode(slots, cap)(
        tm.params, tk, tv, torch.from_numpy(lengths),
        torch.from_numpy(tokens))
    _close(tlog, jlog)
    _close(tk, jk2)                       # the slabs, updated in place
    _close(tv, jv2)


def _config(mod, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_context", 32)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("max_new_tokens", 8)
    for knob, off in (("paged", False), ("spec", False), ("capture", False),
                      ("quant_weights", ""), ("kv_dtype", "f32"),
                      ("eos_id", None)):
        kw.setdefault(knob, off)
    return mod.GenerateConfig(num_heads=H, num_kv_heads=HKV, **kw)


def _serve(mod, model, prompts, **kw):
    sched = mod.DecodeScheduler(model, _config(mod, **kw))
    sched.start()
    try:
        streams = [sched.submit(p) for p in prompts]
        out = [s.tokens(timeout=120) for s in streams]
        reasons = [s.finish_reason for s in streams]
    finally:
        sched.stop()
    return out, reasons


def test_scheduler_streams_match_jax_and_are_batch_independent():
    jm, tm = _models()
    jtoks, _ = _serve(jgen, jm, PROMPTS)
    ttoks, reasons = _serve(tgen, tm, PROMPTS)
    assert reasons == ["max_tokens"] * len(PROMPTS)
    assert all(len(t) == 8 for t in ttoks)
    assert ttoks == jtoks
    # continuous-batching invariant: alone, each stream is the same
    for p, crowd in zip(PROMPTS[:2], ttoks[:2]):
        alone, _ = _serve(tgen, tm, [p])
        assert alone[0] == crowd


def test_scheduler_bf16_kv_runs_and_stops_cleanly():
    _, tm = _models()
    toks, reasons = _serve(tgen, tm, PROMPTS[:2], kv_dtype="bf16",
                           max_new_tokens=4)
    assert reasons == ["max_tokens"] * 2 and all(len(t) == 4 for t in toks)


@pytest.mark.parametrize("knob", [{"paged": True}, {"spec": True},
                                  {"quant_weights": "int8"},
                                  {"capture": True}, {"kv_dtype": "int8"}])
def test_unported_knobs_raise(knob):
    _, tm = _models()
    with pytest.raises(ServingError, match="not yet ported") as ei:
        tgen.DecodeScheduler(tm, _config(tgen, **knob))
    assert ei.value.code == "not_ported"


def test_submit_rejects_prompt_beyond_ladder():
    _, tm = _models()
    sched = tgen.DecodeScheduler(tm, _config(tgen))
    sched.start()
    try:
        with pytest.raises(ServingError) as ei:
            sched.submit(list(range(17)))
        assert ei.value.code == "too_large"
        assert sched.stats()["kv_dtype"] == "float32"
    finally:
        sched.stop()


def test_engine_push_fence_ordering():
    v = engine.new_variable()
    seen = []
    gate = threading.Event()
    engine.push(gate.wait, mutable_vars=[v])
    for i in range(20):
        engine.push(lambda i=i: seen.append(i), mutable_vars=[v])
    f = engine.fence([v])
    assert not f.done()                  # held behind the gated op
    gate.set()
    f.wait(timeout=10)
    assert f.done() and seen == list(range(20))
    engine.wait_for_var(v)
    engine.wait_for_all()
    engine.delete_variable(v)


def test_engine_fence_timeout_raises():
    from mxnet_tpu_torch.base import MXNetError

    v = engine.new_variable()
    gate = threading.Event()
    engine.push(gate.wait, mutable_vars=[v])
    try:
        with pytest.raises(MXNetError, match="not reached"):
            engine.fence([v]).wait(timeout=0.05)
    finally:
        gate.set()
        engine.wait_for_all()
