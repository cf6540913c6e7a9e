"""mxnet_tpu_torch.predict and quant.QuantizedPredictor against the JAX
package, on the CPU.

The same numpy weights and inputs go through both packages' ``Predictor``
(and ``QuantizedPredictor``): an MLP, LeNet, a small conv + BatchNorm net
(aux states) and a tiny GQA decoder LM (2 layers, d 64, 4 heads, 2 kv
heads, vocab 50, seq 16, ``SoftmaxOutput`` head, its label an input as
neither package can infer it through the head's Reshape; the port's
``MultiHeadAttention`` on its plain path on the CPU). Outputs agree within
rtol 1e-5 / atol 1e-6; the int8 / fp8 weights and their scales bit for
bit. Also: ``reshape`` sharing the weights and the quantization, the
reference's error messages, the zero-bound label, ``create`` from a
checkpoint the JAX package wrote, four threads calling ``forward`` at
once, ``quantizable_weights`` and the refused ``export``.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import predict as jpredict
from mxnet_tpu import quant as jquant
from mxnet_tpu_torch import predict as tpredict
from mxnet_tpu_torch import quant as tquant

TOL = {"rtol": 1e-5, "atol": 1e-6}
LM = {"num_classes": 50, "num_layers": 2, "num_heads": 4, "model_dim": 64,
      "ffn_dim": 128, "num_kv_heads": 2}
LM_SEQ = 16


def _mlp(pkg):
    return pkg.models.get_symbol("mlp", num_classes=3, hidden=(8,))


def _lenet(pkg):
    return pkg.models.get_symbol("lenet", num_classes=10)


def _convbn(pkg):
    s = pkg.sym
    net = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=4,
                        pad=(1, 1), name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="relu", name="relu")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool")
    net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def _lm(pkg):
    return pkg.models.get_symbol("transformer-lm", **LM)


# name -> (symbol function, per-example input shape, integer input range)
MODELS = {
    "mlp": (_mlp, (10,), None),
    "lenet": (_lenet, (1, 28, 28), None),
    "convbn": (_convbn, (3, 8, 8), None),
    "lm": (_lm, (LM_SEQ,), LM["num_classes"]),
}


def _params(model, seed=0):
    """Seeded numpy weights (arg: / aux: prefixed) from the port's shape
    inference, the same dict for both packages."""
    build, example, _ = MODELS[model]
    sym = build(mt)
    known = {"data": (1,) + example}
    if MODELS[model][2]:        # the LM's label: one id a position
        known["softmax_label"] = known["data"]
    shapes, _, aux_shapes = sym.infer_shape(**known)
    rng = np.random.RandomState(seed)
    params = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        elif len(s) >= 2:
            # 1/sqrt(fan-in): logits of order one, softmax unsaturated
            v = rng.randn(*s) / np.sqrt(np.prod(s[1:]))
        else:
            v = 0.1 * rng.randn(*s)
        params["arg:" + n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("var") \
            else 0.1 * rng.randn(*s)
        params["aux:" + n] = v.astype(np.float32)
    return params


def _inputs(model, batch, seed=1):
    _, example, vocab = MODELS[model]
    rng = np.random.RandomState(seed)
    if vocab:
        return rng.randint(0, vocab, (batch,) + example).astype(np.float32)
    return rng.uniform(-1, 1, (batch,) + example).astype(np.float32)


def _shapes(model, batch):
    """The bound input shapes: the LM's label is an input."""
    shapes = {"data": (batch,) + MODELS[model][1]}
    if MODELS[model][2]:
        shapes["softmax_label"] = shapes["data"]
    return shapes


def _feed(model, batch, seed=1):
    x = _inputs(model, batch, seed)
    if MODELS[model][2]:
        return {"data": x, "softmax_label": np.zeros_like(x)}
    return {"data": x}


def _both(model, batch=2, quantize=None):
    """(JAX predictor, port predictor) at ``batch``, optionally
    quantized (weight type)."""
    build = MODELS[model][0]
    params = _params(model)
    shapes = _shapes(model, batch)
    jp = jpredict.Predictor(build(mx).tojson(), params, shapes)
    tp = tpredict.Predictor(build(mt).tojson(), params, shapes, device="cpu")
    if quantize:
        jp, tp = jp.quantize(quantize), tp.quantize(quantize)
    return jp, tp


def _close(tp_out, jp_out, what):
    assert len(tp_out) == len(jp_out)
    for t, j in zip(tp_out, jp_out):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), err_msg=what,
                                   **TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_predictor_matches_jax(model):
    jp, tp = _both(model)
    feed = _feed(model, 2)
    _close(tp.forward(**feed), jp.forward(**feed), model)
    assert tp.output_names == jp.output_names
    # set_input / forward() / get_output, the C API's order
    for n, v in feed.items():
        tp.set_input(n, v)
    tp.forward()
    np.testing.assert_allclose(tp.get_output(0).asnumpy(),
                               jp.get_output(0).asnumpy(), **TOL)
    assert tp.capture_stats()["path"] == "eager"


def _q_equal(got, want):
    """A port (q, scale) pair against the JAX package's, bit for bit."""
    gq, wq = got["q"], np.asarray(want["q"])
    if gq.dtype == torch.float8_e4m3fn:
        assert str(wq.dtype) == "float8_e4m3fn"
        np.testing.assert_array_equal(gq.view(torch.uint8).numpy(),
                                      wq.view(np.uint8))
    else:
        assert gq.dtype == torch.int8 and wq.dtype == np.int8
        np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


@pytest.mark.parametrize("weight_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_quantized_predictor_matches_jax(model, weight_dtype):
    jp, tp = _both(model, quantize=weight_dtype)
    assert isinstance(tp, tquant.QuantizedPredictor)
    names = tquant.quantizable_weights(tp._symbol)
    assert names == jquant.quantizable_weights(jp._symbol)
    assert names and set(names) == {n for n, v in tp._qvals.items()
                                    if isinstance(v, dict)}
    for n in names:
        _q_equal(tp._qvals[n], jp._qvals[n])
    feed = _feed(model, 2)
    _close(tp.forward(**feed), jp.forward(**feed), model)


def test_quantizable_weights_and_export_refused():
    for model in MODELS:
        build = MODELS[model][0]
        assert tquant.quantizable_weights(build(mt)) == \
            jquant.quantizable_weights(build(mx))
    jp, tp = _both("mlp", quantize="int8")
    with pytest.raises(mt.MXNetError) as te:
        tp.export("unused")
    with pytest.raises(mx.base.MXNetError) as je:
        jp.export("unused")
    assert str(te.value) == str(je.value)
    with pytest.raises(mt.MXNetError, match="not ported"):
        _both("mlp")[1].export("unused")


@pytest.mark.parametrize("model", ["lenet", "convbn", "lm"])
def test_reshape_shares_the_weights(model):
    jp, tp = _both(model, batch=1)
    c0 = tpredict.compile_count()
    t4, j4 = tp.reshape(_shapes(model, 4)), jp.reshape(_shapes(model, 4))
    assert tpredict.compile_count() == c0 + 1
    assert t4._arg_params is tp._arg_params
    assert t4._aux_params is tp._aux_params
    for n, a in tp._arg_params.items():
        assert t4._arg_params[n]._data.data_ptr() == a._data.data_ptr()
    feed = _feed(model, 4)
    _close(t4.forward(**feed), j4.forward(**feed), model)
    # the smaller bind is untouched by the larger one
    one = {n: v[:1] for n, v in feed.items()}
    _close(tp.forward(**one), jp.forward(**one), model)


def test_reshape_shares_the_quantization():
    jp, tp = _both("lm", batch=1, quantize="int8")
    t4 = tp.reshape(_shapes("lm", 4))
    j4 = jp.reshape(_shapes("lm", 4))
    assert isinstance(t4, tquant.QuantizedPredictor)
    assert t4._qvals is tp._qvals and t4._qconfig is tp._qconfig
    feed = _feed("lm", 4)
    _close(t4.forward(**feed), j4.forward(**feed), "lm int8 (4, 16)")
    before = tquant.quant_params_bytes().get("int8", 0)
    tp.reshape(_shapes("lm", 2))
    assert tquant.quant_params_bytes().get("int8", 0) == before


def test_the_reference_error_messages():
    jp, tp = _both("mlp")
    x = _inputs("mlp", 2)
    cases = [lambda p: p.set_input("nope", x),
             lambda p: p.set_input("data", x[:1]),
             lambda p: p.forward()]
    for case in cases:
        with pytest.raises(mx.base.MXNetError) as je:
            case(jp)
        with pytest.raises(mt.MXNetError) as te:
            case(tp)
        assert str(te.value) == str(je.value)


def test_the_label_is_bound_to_zeros():
    jp, tp = _both("convbn", batch=2)
    assert tp._zero_bound == ["softmax_label"]
    want = jp._arg_params["softmax_label"]
    got = tp._zeros["softmax_label"]
    assert tuple(got.shape) == want.shape and not got.any()
    # a reshape binds the label at its own shape
    t4 = tp.reshape(_shapes("convbn", 4))
    assert tuple(t4._zeros["softmax_label"].shape) == (4,)
    # the LM's label sits behind a Reshape: neither package infers it
    build, params = MODELS["lm"][0], _params("lm")
    with pytest.raises(mx.base.MXNetError) as je:
        jpredict.Predictor(build(mx).tojson(), params,
                           {"data": (1, LM_SEQ)})
    with pytest.raises(mt.MXNetError) as te:
        tpredict.Predictor(build(mt).tojson(), params,
                           {"data": (1, LM_SEQ)}, device="cpu")
    assert "softmax_label" in str(je.value) and \
        "softmax_label" in str(te.value)


def test_create_from_a_jax_checkpoint(tmp_path):
    params = _params("convbn")
    jsym = _convbn(mx)
    prefix = str(tmp_path / "convbn")
    mx.model.save_checkpoint(
        prefix, 3, jsym,
        {k[4:]: mx.nd.array(v) for k, v in params.items()
         if k.startswith("arg:")},
        {k[4:]: mx.nd.array(v) for k, v in params.items()
         if k.startswith("aux:")})
    shapes = {"data": (2, 3, 8, 8)}
    tp = tpredict.create(prefix, 3, shapes, device="cpu")
    jp = jpredict.create(prefix, 3, shapes)
    x = _inputs("convbn", 2)
    _close(tp.forward(data=x), jp.forward(data=x), "create")


def test_four_threads_call_forward_at_once():
    jp, tp = _both("lm", batch=2)
    xs = [_feed("lm", 2, seed=10 + i) for i in range(4)]
    want = [jp.forward(**x)[0].asnumpy() for x in xs]
    got, errors = {}, []
    start = threading.Barrier(4, timeout=5.0)

    def call(i):
        try:
            start.wait()
            for _ in range(3):
                got[i] = tp.forward(**xs[i])[0].asnumpy()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5.0)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], **TOL)


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _params("mlp")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        tpredict.Predictor(_mlp(mt).tojson(), params, {"data": (1, 10)})
    p = tpredict.Predictor(_mlp(mt).tojson(), params, {"data": (1, 10)},
                           device="cpu")
    assert p.forward(data=_inputs("mlp", 1))[0].shape == (1, 3)
    assert tpredict.disk_load_count() == 0


def test_compile_count_counts_every_bind():
    params = _params("mlp")
    c0 = tpredict.compile_count()
    p = tpredict.Predictor(_mlp(mt).tojson(), params, {"data": (1, 10)},
                           device="cpu")
    q = p.quantize("int8")
    q.reshape({"data": (3, 10)})
    assert tpredict.compile_count() - c0 == 3
