"""mxnet_tpu_torch training path against the JAX package, on the CPU.

The same numpy weights and batch go through both packages'
``models.get_symbol`` -> ``simple_bind`` -> ``copy_params_from`` ->
``forward(is_train=True)`` / ``backward()`` -> ``Updater``: a tiny GQA
``transformer-lm`` (MakeLoss head) and an MLP (``SoftmaxOutput`` head).
The loss, every gradient, and every parameter after 3 SGD-momentum and 3
Adam steps must agree. Tolerance: rtol 1e-4 / atol 1e-5 on the first step,
widened to rtol 1e-3 / atol 1e-4 after six updates — both sides run f32 on
the CPU, but attention, reductions and matmuls sum in different orders,
and Adam's 1/sqrt(var) amplifies last-bit differences in small gradients.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

STEP_TOL = {"rtol": 1e-4, "atol": 1e-5}
TRAIN_TOL = {"rtol": 1e-3, "atol": 1e-4}
LM = {"num_classes": 97, "num_layers": 2, "num_heads": 4, "model_dim": 64,
      "ffn_dim": 128, "num_kv_heads": 2}


def _lm(pkg):
    return pkg.models.get_symbol("transformer-lm", scalar_loss=True, **LM)


def _mlp(pkg):
    return pkg.models.get_symbol("mlp", num_classes=10, hidden=(32, 16))


# name -> (symbol builder, input shapes, label range)
MODELS = {
    "lm": (_lm, {"data": (2, 32), "softmax_label": (2, 32)},
           LM["num_classes"]),
    "mlp": (_mlp, {"data": (8, 20), "softmax_label": (8,)}, 10),
}
INPUTS = ("data", "softmax_label")


def _bind_both(model, seed=0):
    build, shapes, classes = MODELS[model]
    jsym, tsym = build(mx), build(mt)
    assert jsym.list_arguments() == tsym.list_arguments()
    reqs = {n: ("null" if n in INPUTS else "write")
            for n in jsym.list_arguments()}
    jexe = jsym.simple_bind(mx.cpu(), grad_req=reqs, **shapes)
    texe = tsym.simple_bind(mt.cpu(), grad_req=reqs, **shapes)
    rng = np.random.RandomState(seed)
    params = {}
    for n, a in jexe.arg_dict.items():
        assert texe.arg_dict[n].shape == a.shape, n
        if n == "data" and model == "lm":
            v = rng.randint(0, classes, a.shape)
        elif n == "softmax_label":
            v = rng.randint(0, classes, a.shape)
        elif n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*a.shape)
        else:
            v = 0.2 * rng.randn(*a.shape)
        params[n] = v.astype(np.float32)
    jexe.copy_params_from(params)
    texe.copy_params_from(params)
    return jsym, jexe, texe, reqs


def _close(got, want, what, tol):
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_backward_matches_jax(model):
    _, jexe, texe, reqs = _bind_both(model)
    jexe.forward(is_train=True)
    jexe.backward()
    texe.forward(is_train=True)
    texe.backward()
    _close(texe.outputs[0].asnumpy(), jexe.outputs[0].asnumpy(), "loss",
           STEP_TOL)
    for n, req in reqs.items():
        if req != "null":
            _close(texe.grad_dict[n].asnumpy(), jexe.grad_dict[n].asnumpy(),
                   "grad " + n, STEP_TOL)


def _optimizers(pkg, names):
    idx2name = dict(enumerate(names))
    return [pkg.optimizer.SGD(learning_rate=0.05, momentum=0.9, wd=1e-4,
                              param_idx2name=idx2name),
            pkg.optimizer.Adam(learning_rate=1e-3, wd=1e-4, clip_gradient=5.0,
                               param_idx2name=idx2name)]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_sgd_then_adam_steps_match_jax(model):
    jsym, jexe, texe, reqs = _bind_both(model, seed=1)
    names = jsym.list_arguments()
    for jopt, topt in zip(_optimizers(mx, names), _optimizers(mt, names)):
        jup, tup = mx.optimizer.Updater(jopt), mt.optimizer.Updater(topt)
        for step in range(3):
            jexe.forward(is_train=True)
            jexe.backward()
            texe.forward_backward()
            _close(texe.outputs[0].asnumpy(), jexe.outputs[0].asnumpy(),
                   "%s step %d loss" % (type(topt).__name__, step),
                   TRAIN_TOL)
            for i, n in enumerate(names):
                if reqs[n] != "null":
                    jup(i, jexe.grad_dict[n], jexe.arg_dict[n])
                    tup(i, texe.grad_dict[n], texe.arg_dict[n])
    for n in names:
        _close(texe.arg_dict[n].asnumpy(), jexe.arg_dict[n].asnumpy(),
               "param " + n, TRAIN_TOL)


def test_grad_req_add_accumulates_and_null_skips():
    _, _, texe, reqs = _bind_both("mlp")
    texe.forward_backward()
    once = {n: g.asnumpy().copy() for n, g in texe.grad_dict.items()}
    texe.grad_req["fc1_weight"] = "add"
    texe.grad_req["fc1_bias"] = "null"
    texe.grad_dict["fc1_bias"][:] = 7.0
    texe.forward_backward()
    np.testing.assert_allclose(texe.grad_dict["fc1_weight"].asnumpy(),
                               2 * once["fc1_weight"], rtol=1e-6)
    np.testing.assert_allclose(texe.grad_dict["fc2_weight"].asnumpy(),
                               once["fc2_weight"], rtol=1e-6)
    assert (texe.grad_dict["fc1_bias"].asnumpy() == 7.0).all()


def test_backward_without_forward_runs_one_and_head_grads_scale():
    """The SoftmaxOutput head ignores head gradients (reference
    semantics), so a backward with out_grads equals one without."""
    _, _, texe, _ = _bind_both("mlp")
    texe.backward()
    first = texe.grad_dict["fc3_weight"].asnumpy().copy()
    assert np.abs(first).sum() > 0
    texe.forward(is_train=True)
    texe.backward(out_grads=[mt.nd.ones(texe.outputs[0].shape, "cpu") * 3])
    np.testing.assert_allclose(texe.grad_dict["fc3_weight"].asnumpy(), first,
                               rtol=1e-6)


def test_xavier_init_from_a_seed_matches_jax():
    """One numpy seed gives both packages the same weights (the draws come
    from numpy on both sides)."""
    build, shapes, _ = MODELS["lm"]
    jsym, tsym = build(mx), build(mt)
    jexe = jsym.simple_bind(mx.cpu(), grad_req="null", **shapes)
    texe = tsym.simple_bind(mt.cpu(), grad_req="null", **shapes)
    np.random.seed(3)
    jinit = mx.initializer.Xavier(factor_type="in", magnitude=2)
    for n, a in jexe.arg_dict.items():
        if n not in INPUTS:
            jinit(mx.initializer.InitDesc(n), a)
    tinit = mt.initializer.Xavier(factor_type="in", magnitude=2,
                                  rng=np.random.RandomState(3))
    for n, a in texe.arg_dict.items():
        if n not in INPUTS:
            tinit(mt.initializer.InitDesc(n), a)
    for n in jexe.arg_dict:
        np.testing.assert_array_equal(texe.arg_dict[n].asnumpy(),
                                      jexe.arg_dict[n].asnumpy(), err_msg=n)


def test_simple_bind_shapes_match_jax():
    for model in sorted(MODELS):
        build, shapes, _ = MODELS[model]
        want = build(mx).infer_shape(**shapes)
        got = build(mt).infer_shape(**shapes)
        assert got == tuple(want) or list(got) == list(want), model
        with pytest.raises(mt.MXNetError, match="cannot infer"):
            build(mt).infer_shape()


def test_executor_refuses_arrays_on_another_device():
    sym = _mlp(mt)
    exe = sym.simple_bind("cpu", data=(4, 20))
    args = dict(exe.arg_dict)
    with pytest.raises(mt.MXNetError, match="lies on"):
        mt.executor.Executor(sym, "meta", args)
    assert torch.device("cpu") == exe.arg_dict["fc1_weight"].context
