"""Weight quantization of mxnet_tpu_torch against mxnet_tpu.

``quant.py``, ``ops/contrib.py``'s ``quantize`` / ``dequantize``,
``ops/matrix.py``'s ``quantized_matmul`` and ``QuantizedFullyConnected``,
and the quantized decode model, on the same numpy inputs in both
packages (the small LM of ``test_torch_decode.py``: L 2, d 64, H 4,
Hkv 2, V 64). int8 values are equal and scales within 1e-6 relative;
fp8-e4m3 values are equal byte for byte; the int8 product's int32
accumulator is equal; f32 results within 1e-5 relative (sums in another
order), bf16 dequant-on-load within one bf16 rounding of the product;
logits within 1e-4, streams equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import quant as jquant
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.matrix import quantized_matmul as jqmm
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import quant as tquant
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.kernels import _launches
from mxnet_tpu_torch.ops.matrix import int8_product, quantized_matmul
from mxnet_tpu_torch.serving import generate as tgen

from test_torch_decode import _close, _config, _models, _serve

SCALE_RTOL = 1e-6
F32_RTOL = 1e-5


def _w(seed, *shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)


def _q_equal(got, want):
    """int8 equal; fp8 byte for byte (the reference's ml_dtypes array
    read as bytes)."""
    want = np.asarray(want)
    if got.dtype == torch.float8_e4m3fn:
        assert str(want.dtype) == "float8_e4m3fn"
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      want.view(np.uint8))
    else:
        assert got.dtype == torch.int8 and want.dtype == np.int8
        np.testing.assert_array_equal(got.numpy(), want)


# --- the weight pass ----------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("shape,axis", [((24, 48), 0), ((3, 24, 48), (0, 1))])
def test_quantize_weight_matches_jax(weight_dtype, shape, axis):
    w = _w(1, *shape)
    w[0, ..., 0] = 0.0                         # a zero entry, not a row
    jq, js = jquant.quantize_weight(w, weight_dtype, axis)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w), weight_dtype, axis)
    _q_equal(tq, jq)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == js.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL,
                               atol=0)
    back = tquant.dequantize_weight(tq, ts)
    assert back.shape == w.shape and back.dtype == torch.float32
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jquant.dequantize_weight(jq, js)),
        rtol=SCALE_RTOL, atol=0)


def test_quantize_weight_at_round_half_and_absmax():
    """Values exactly on halves of their row's scale, and each row's
    absmax: both packages round half to even from one f32 division, and
    the absmax maps onto 127 (int8) or 448 (fp8) exactly."""
    w = np.array([[127.0, 0.5, 1.5, -2.5, 63.5, -127.0],
                  [448.0, 0.25, 3.0, -448.0, 7.0, 100.0]], np.float32)
    for dtype in ("int8", "fp8_e4m3"):
        jq, _ = jquant.quantize_weight(w, dtype, 0)
        tq, _ = tquant.quantize_weight(torch.from_numpy(w), dtype, 0)
        _q_equal(tq, jq)
    tq, _ = tquant.quantize_weight(torch.from_numpy(w), "int8", 0)
    assert tq[0].tolist() == [127, 0, 2, -2, 64, -127]


def test_int8_scales_are_a_true_division_on_every_device(monkeypatch):
    """``amax / qmax`` as the reference divides, not ``amax * (1 / qmax)``
    (PyTorch's shortcut for a CUDA tensor divided by a Python number,
    one ulp off for about one value in twenty): the weight, activation and
    KV scales all come from ``symmetric_scale``, which divides by a tensor.
    Here on values where the two differ."""
    from mxnet_tpu_torch.ops import contrib, matrix
    from mxnet_tpu_torch.serving.generate import model as tmodel

    amax = np.random.RandomState(13).rand(4096).astype(np.float32) * 10
    recip = amax * (np.float32(1) / np.float32(127))
    true = amax / np.float32(127)
    assert (recip != true).sum() > 100
    got = contrib.symmetric_scale(torch.from_numpy(amax), 127.0)
    np.testing.assert_array_equal(got.numpy(), true)
    calls = []
    real = contrib.symmetric_scale

    def counted(a, qmax):
        calls.append(qmax)
        return real(a, qmax)

    for mod in (contrib, matrix, tmodel):
        monkeypatch.setattr(mod, "symmetric_scale", counted)
    w = torch.from_numpy(_w(14, 8, 16))
    q, s = tquant.quantize_weight(w, "int8", 0)
    tquant.quantize_weight(w, "fp8_e4m3", 0)
    quantized_matmul(torch.ones(2, 16), q, s, "int8")
    tmodel._quantize_kv(torch.ones(1, 2, 3, 4))
    assert calls == [127.0, 448.0, 127.0, 127.0]
    # dequantize divides max_range by qmax (int8, fp8) and the uint8 range
    # by 255 through true_divide, a division by a tensor on every device
    divides = []
    real_divide = contrib.true_divide

    def counted_divide(num, den):
        divides.append((type(num).__name__, den if isinstance(den, float)
                        else type(den).__name__))
        return real_divide(num, den)

    monkeypatch.setattr(contrib, "true_divide", counted_divide)
    op = treg.get_op("dequantize")
    lo, hi = torch.tensor([-1.3]), torch.tensor([2.7])
    for data in (torch.ones(4, dtype=torch.int8),
                 torch.ones(4).to(torch.float8_e4m3fn),
                 torch.ones(4, dtype=torch.uint8)):
        out = op.impl(op.parse_attrs({}), (data, lo, hi), (),
                      treg.OpContext())[0][0]
        assert out.dtype == torch.float32
    assert divides == [("Tensor", 127.0), ("Tensor", 448.0),
                       ("Tensor", 255.0)]
    x = torch.from_numpy(amax)
    np.testing.assert_array_equal(real_divide(x, 255.0).numpy(),
                                  amax / np.float32(255))
    np.testing.assert_array_equal(real_divide(255.0, x).numpy(),
                                  np.float32(255) / amax)


def _uint8_quantize(reg, x, lo, hi, jax_side):
    return np.asarray(_run_op(reg, "quantize", [x, lo, hi],
                              {"out_type": "uint8"}, jax_side)[0])


def test_uint8_quantize_scale_is_a_true_division():
    """``255 / (max_range - min_range)`` divides, as the reference does;
    ``Tensor.__rtruediv__`` would take the reciprocal times 255, an ulp off
    for a quarter of ranges, and a value that lands within an ulp of
    k + 0.5 then rounds to the other neighbour. The range of the example
    (lo -1.3079847, hi 0.087778695, x -0.98778015: 59, not 58) and seeded
    ranges with inputs at every k + 0.5 of each: exact."""
    lo = np.array([-1.3079847], np.float32)
    hi = np.array([0.087778695], np.float32)
    x = np.array([-0.98778015], np.float32)
    assert _uint8_quantize(jreg, x, lo, hi, True).tolist() == [59]
    assert _uint8_quantize(treg, x, lo, hi, False).tolist() == [59]
    rng = np.random.RandomState(21)
    for _ in range(40):
        lo = -rng.rand(1).astype(np.float32) * 3
        hi = rng.rand(1).astype(np.float32) * 3
        scale = np.float32(255) / (hi - lo)
        # inputs whose scaled value sits at each k + 0.5, where one ulp of
        # the scale moves the rounding
        x = ((np.arange(255, dtype=np.float32) + 0.5) / scale + lo)             .astype(np.float32)
        x = np.concatenate([x, rng.uniform(lo, hi, 64).astype(np.float32)])
        np.testing.assert_array_equal(
            _uint8_quantize(treg, x, lo, hi, False),
            _uint8_quantize(jreg, x, lo, hi, True))


def test_dtype_names_and_config_validation():
    for name in ("int8", "fp8", "fp8_e4m3", "float8_e4m3", " INT8 "):
        assert tquant.normalize_weight_dtype(name) == \
            jquant.normalize_weight_dtype(name)
    for name in ("f32", "fp32", "bf16", "bfloat16", "int8"):
        assert tquant.normalize_kv_dtype(name) == \
            jquant.normalize_kv_dtype(name)
    assert tquant.WEIGHT_DTYPES == jquant.WEIGHT_DTYPES
    assert tquant.KV_DTYPES == jquant.KV_DTYPES
    assert tquant.DECODE_QUANT_WEIGHTS == jquant.DECODE_QUANT_WEIGHTS
    for bad in (lambda: tquant.normalize_weight_dtype("int4"),
                lambda: tquant.normalize_kv_dtype("fp8"),
                lambda: tquant.QuantConfig(weight_dtype="int8",
                                           act_dtype="int4")):
        with pytest.raises(MXNetError):
            bad()
    c = tquant.QuantConfig(weight_dtype="fp8", act_dtype="BF16")
    assert (c.weight_dtype, c.act_dtype) == ("fp8_e4m3", "bf16")


def test_quant_config_reads_the_env_at_construction(monkeypatch):
    monkeypatch.setenv("MXNET_QUANT_WEIGHT_DTYPE", "fp8")
    monkeypatch.setenv("MXNET_QUANT_ACT_DTYPE", "f32")
    c = tquant.QuantConfig()
    assert (c.weight_dtype, c.act_dtype) == ("fp8_e4m3", "float32")


def test_quant_params_bytes_counts_each_pass():
    _, tm = _models()
    before = tquant.quant_params_bytes().get("int8", 0)
    qm = tquant.quantize_decode_model(tm, tquant.QuantConfig("int8", "int8"))
    want = sum(qm.params[n].numel() for n in tquant.DECODE_QUANT_WEIGHTS)
    assert tquant.quant_params_bytes()["int8"] - before == want
    assert tm.params["wq"].dtype == torch.float32       # left as it was
    assert qm.quant_act == "int8" and qm.params["embed"] is tm.params["embed"]


# --- the product ----------------------------------------------------------------

def test_int8_product_is_the_exact_integer_product():
    rng = np.random.RandomState(5)
    for m, k, n in ((8, 64, 24), (40, 48, 16), (3, 12, 7)):
        x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
        before = int8_product.launches
        acc = int8_product(x, w)
        assert acc.dtype == torch.int32
        assert torch.equal(acc, x.int() @ w.int().t())
        assert int8_product.launches == before + 1
    assert "int8_product" in {getattr(c, "__name__", "")
                              for c in _launches._COUNTERS}


@pytest.mark.parametrize("act", ["int8", "float32", "bf16"])
@pytest.mark.parametrize("weight_dtype", ["int8", "fp8_e4m3"])
def test_quantized_matmul_matches_jax(act, weight_dtype):
    rng = np.random.RandomState(6)
    w = _w(7, 24, 48)
    x = rng.randn(2, 5, 48).astype(np.float32)   # 3-D: rows flattened
    jq, js = jquant.quantize_weight(w, weight_dtype, 0)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w), weight_dtype, 0)
    want = np.asarray(jqmm(jnp.asarray(x), jq, js, act))
    got = quantized_matmul(torch.from_numpy(x), tq, ts, act)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if act == "bf16":
        # bf16 products of bf16 values, f32 sums in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                                   atol=1e-6)


def test_int8_activation_path_accumulator_equals_jax():
    """The activations' int8 rows and the int32 accumulator equal the
    reference's, so only the f32 rescale can differ, and it does not."""
    import jax

    rng = np.random.RandomState(8)
    w = _w(9, 40, 64)
    x = rng.randn(8, 64).astype(np.float32)
    jq, js = jquant.quantize_weight(w, "int8", 0)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w), "int8", 0)
    jx = jnp.asarray(x)
    jxs = jnp.maximum(jnp.max(jnp.abs(jx), axis=1, keepdims=True),
                      1e-12) / 127.0
    jxq = jnp.round(jx / jxs).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jq, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tx = torch.from_numpy(x)
    txs = torch.clamp(tx.abs().amax(1, keepdim=True), min=1e-12) / 127.0
    txq = torch.round(tx / txs).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(int8_product(txq, tq).numpy(),
                                  np.asarray(jacc))
    np.testing.assert_array_equal(
        quantized_matmul(tx, tq, ts, "int8").numpy(),
        np.asarray(jqmm(jx, jq, js, "int8")))


# --- the ops ----------------------------------------------------------------------

def _run_op(reg, name, arrays, attrs, jax_side):
    op = reg.get_op(name)
    parsed = op.parse_attrs(dict(attrs))
    if jax_side:
        outs, _ = op.impl(parsed, tuple(jnp.asarray(a) for a in arrays), (),
                          reg.OpContext(False, None))
        return list(outs)
    outs, _ = op.impl(parsed, tuple(torch.from_numpy(a.copy())
                                    for a in arrays), (), reg.OpContext())
    return list(outs)


@pytest.mark.parametrize("out_type,axis", [("int8", None), ("int8", 0),
                                           ("fp8_e4m3", 1), ("uint8", None)])
def test_quantize_and_dequantize_ops_match_jax(out_type, axis):
    x = _w(10, 6, 8) * 3
    lo, hi = np.array([-2.0], np.float32), np.array([2.5], np.float32)
    attrs = {"out_type": out_type, "axis": axis} if out_type != "uint8" \
        else {"out_type": out_type}
    jout = _run_op(jreg, "quantize", [x, lo, hi], attrs, True)
    tout = _run_op(treg, "quantize", [x, lo, hi], attrs, False)
    if out_type == "uint8":
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    else:
        _q_equal(tout[0], jout[0])
    for a, b in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=SCALE_RTOL, atol=0)
    jq = [np.asarray(o) for o in jout]
    back_j = _run_op(jreg, "dequantize", jq, {}, True)[0]
    tq = [tout[0]] + [t for t in tout[1:]]
    op = treg.get_op("dequantize")
    back_t = op.impl(op.parse_attrs({}), tuple(tq), (), treg.OpContext())[0]
    np.testing.assert_allclose(back_t[0].numpy(), np.asarray(back_j),
                               rtol=F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("act", ["int8", "float32"])
@pytest.mark.parametrize("no_bias", [False, True])
def test_quantized_fully_connected_matches_jax(act, no_bias):
    rng = np.random.RandomState(11)
    w = _w(12, 8, 12)
    x = rng.randn(3, 2, 6).astype(np.float32)    # flattened to (3, 12)
    b = rng.randn(8).astype(np.float32)
    jq, js = jquant.quantize_weight(w, "int8", 0)
    arrays = [x, np.asarray(jq), np.asarray(js)] + ([] if no_bias else [b])
    attrs = {"num_hidden": 8, "no_bias": no_bias, "act_dtype": act}
    want = _run_op(jreg, "QuantizedFullyConnected", arrays, attrs, True)[0]
    got = _run_op(treg, "QuantizedFullyConnected", arrays, attrs, False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                               atol=1e-6)
    assert treg.get_op("QuantizedFullyConnected").no_grad_inputs == (
        "weight", "scale")


# --- the quantized decode model -----------------------------------------------------

def _quantized_pair(weight, act):
    jm, tm = _models()
    jq = jquant.quantize_decode_model(jm, jquant.QuantConfig(weight, act))
    tq = tquant.quantize_decode_model(tm, tquant.QuantConfig(weight, act))
    return jq, tq


@pytest.mark.parametrize("weight", ["int8", "fp8_e4m3"])
def test_params_from_numpy_takes_the_references_quantized_params(weight):
    jq, tq = _quantized_pair(weight, "int8")
    got = tgen.params_from_numpy({k: np.asarray(v)
                                  for k, v in jq.params.items()}, "cpu")
    assert sorted(got) == sorted(jq.params) == sorted(tq.params)
    for name in tquant.DECODE_QUANT_WEIGHTS:
        _q_equal(got[name], jq.params[name])
        _q_equal(tq.params[name], jq.params[name])
        assert got[name + "_scale"].dtype == torch.float32
    half = tgen.params_from_numpy({k: np.asarray(v)
                                   for k, v in jq.params.items()}, "cpu",
                                  dtype="bfloat16")
    assert half["w1_scale"].dtype == torch.float32
    assert half["ln1_g"].dtype == torch.bfloat16


@pytest.mark.parametrize("weight,act", [("int8", "int8"),
                                        ("fp8_e4m3", "int8")])
def test_quantized_prefill_and_decode_match_jax(weight, act):
    """Prefill, admit and two teacher-forced steps of the quantized model
    in both packages: logits within 1e-4."""
    import jax

    jq, tq = _quantized_pair(weight, act)
    slots, cap, bucket = 2, 24, 8
    prompt = [4, 8, 15, 16, 23]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    n = np.array([len(prompt)], np.int32)
    jl, jk_new, jv_new = jax.jit(jq.build_prefill(bucket, cap))(
        jq.params, jnp.asarray(toks), jnp.asarray(n))
    tl, tk_new, tv_new = tq.build_prefill(bucket, cap)(
        tq.params, torch.from_numpy(toks), torch.from_numpy(n))
    _close(tl, jl)
    shape = tq.kv_slab_shape(slots, cap)
    jk, jv = jq.build_admit(slots, cap)(
        jnp.zeros(shape), jnp.zeros(shape), jk_new, jv_new,
        jnp.asarray(0, jnp.int32))
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tq.build_admit(slots, cap)(tk, tv, tk_new, tv_new, 0)
    jdec = jax.jit(jq.build_decode(slots, cap))
    tdec = tq.build_decode(slots, cap)
    lengths = np.array([len(prompt), 0], np.int32)
    for tok in (42, 7):
        tokens = np.array([tok, 0], np.int32)
        jlog, jk, jv = jdec(jq.params, jk, jv, jnp.asarray(lengths),
                            jnp.asarray(tokens))
        tlog = tdec(tq.params, tk, tv, torch.from_numpy(lengths),
                    torch.from_numpy(tokens))
        _close(tlog[:1], np.asarray(jlog)[:1])
        lengths[0] += 1


@pytest.mark.parametrize("quant_weights,paged", [("int8", False),
                                                 ("fp8", True)])
def test_scheduler_quant_weights_streams_match_jax(quant_weights, paged):
    jm, tm = _models()
    prompts = [[3, 7, 1], [5, 9, 2, 8, 8, 1, 4], [60, 2, 33, 4, 5, 6]]
    kw = dict(quant_weights=quant_weights, paged=paged, block_tokens=4,
              num_blocks=0, prefix_share=True)
    jtoks, _ = _serve(jgen, jm, prompts, **kw)
    ttoks, reasons = _serve(tgen, tm, prompts, **kw)
    assert reasons == ["max_tokens"] * 3
    assert ttoks == jtoks


def test_scheduler_quantizes_at_construction_and_reports_it():
    _, tm = _models()
    sched = tgen.DecodeScheduler(tm, _config(tgen, quant_weights="int8"))
    assert sched.model is not tm and "wq_scale" in sched.model.params
    assert sched.model.params["wq"].dtype == torch.int8
    assert sched.stats()["quant_weights"] == "int8"
    # an already quantized model is not quantized again
    again = tgen.DecodeScheduler(sched.model,
                                 _config(tgen, quant_weights="int8"))
    assert again.model is sched.model
    assert tgen.DecodeScheduler(tm, _config(tgen)).stats()[
        "quant_weights"] == "off"
    with pytest.raises(MXNetError, match="MXNET_QUANT_WEIGHT_DTYPE"):
        tgen.DecodeScheduler(tm, _config(tgen, quant_weights="int4"))
    with pytest.raises(MXNetError, match="MXNET_DECODE_KV_DTYPE"):
        tgen.DecodeScheduler(tm, _config(tgen, kv_dtype="fp8"))


def test_f32_model_without_scales_is_the_plain_product():
    """No ``_scale`` sibling: ``_mm`` is ``x @ W.T`` exactly."""
    from mxnet_tpu_torch.serving.generate.model import _mm

    _, tm = _models()
    x = torch.randn(3, tm.dm, generator=torch.Generator().manual_seed(0))
    assert torch.equal(_mm(tm.params, x, "wq", 1),
                       x @ tm.params["wq"][1].T)
