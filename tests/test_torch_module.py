"""mxnet_tpu_torch's Module training path against the JAX package, on the
CPU: ``io.NDArrayIter``, the metrics, and ``Module.fit`` itself.

The same numpy data, the same initializer draws (numpy's global state,
seeded before each fit, as both packages' ``Xavier`` read it) and the same
SGD-momentum hyperparameters go into both packages' ``Module.fit``:

- MLP and LeNet, 3 batches: every parameter and the metrics after each
  batch within rtol 1e-5 / atol 1e-6 (f32 both sides, other summation
  orders; these nets have no ReLU near a tie at these seeds);
- ResNet-18 at 3 x 32 x 32, 10 classes, batch 2, 2 batches: each
  parameter's update (its change from the initial weights) within 2% of
  the reference's in L2 norm, each aux state's change within 1e-3, the
  metrics within 1e-4. A ReLU input within f32 rounding of 0 can take the
  other branch in one package, and batch norm's backward spreads that over
  its channel, so the updates differ by more than rounding alone would.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools.resnet import change_err

TOL = {"rtol": 1e-5, "atol": 1e-6}


# --- NDArrayIter ---------------------------------------------------------------
def _batches(pkg, handle, n=10, batch=4, **kw):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 3).astype(np.float32)
    y = np.arange(n, dtype=np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, last_batch_handle=handle,
                            **kw)
    out = []
    for _epoch in range(2):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    desc = [(d.name, tuple(d.shape)) for d in it.provide_data
            + it.provide_label]
    return out, desc


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    got, got_desc = _batches(mt, handle)
    want, want_desc = _batches(mx, handle)
    assert got_desc == want_desc
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for (gx, gy, gp), (wx, wy, wp) in zip(ge, we):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gp == wp


def test_ndarray_iter_yields_host_arrays_and_named_inputs():
    it = mt.io.NDArrayIter({"a": np.zeros((4, 2)), "b": np.ones((4, 1))},
                           {"lab": np.arange(4)}, batch_size=2)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    assert [d.name for d in it.provide_label] == ["lab"]
    batch = next(iter(it))
    assert all(a.context == torch.device("cpu") for a in batch.data)
    with pytest.raises(ValueError):
        mt.io.NDArrayIter(np.zeros((2, 3)), batch_size=3)


# --- metrics -------------------------------------------------------------------
def _metric_inputs(pkg):
    rng = np.random.RandomState(1)
    pred = rng.rand(6, 5).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rng.randint(0, 5, 6).astype(np.float32)
    return [pkg.nd.array(label, pkg.cpu())], [pkg.nd.array(pred, pkg.cpu())]


def _feval(label, pred):
    return float(np.abs(pred.argmax(1) - label).sum())


METRICS = {
    "acc": lambda pkg: pkg.metric.create("acc"),
    "top_k": lambda pkg: pkg.metric.TopKAccuracy(top_k=2),
    "ce": lambda pkg: pkg.metric.create("ce"),
    "perplexity": lambda pkg: pkg.metric.Perplexity(ignore_label=None),
    "perplexity_ignore": lambda pkg: pkg.metric.Perplexity(ignore_label=3),
    "loss": lambda pkg: pkg.metric.create("loss"),
    "np": lambda pkg: pkg.metric.np(_feval),
    "composite": lambda pkg: pkg.metric.create(["acc", "ce"]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    got, want = METRICS[name](mt), METRICS[name](mx)
    for _ in range(2):                   # accumulate over two updates
        got.update(*_metric_inputs(mt))
        want.update(*_metric_inputs(mx))
    g, w = got.get_name_value(), want.get_name_value()
    assert [n for n, _ in g] == [n for n, _ in w]
    np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                               rtol=1e-6)
    got.reset()
    assert np.isnan(got.get_name_value()[0][1])


def test_metric_create_rejects_unknown_names():
    with pytest.raises(ValueError, match="Metric must be"):
        mt.metric.create("no-such-metric")


# --- Module.fit ----------------------------------------------------------------
# name -> (model kwargs, data shape, batch, classes, batches)
FITS = {
    "mlp": ({"hidden": (16, 8)}, (20,), 8, 10, 3),
    "lenet": ({}, (1, 28, 28), 4, 10, 3),
    "resnet-18": ({"image_shape": (3, 32, 32)}, (3, 32, 32), 2, 10, 2),
}


def _fit(pkg, name, record_speed=False):
    kwargs, shape, batch, classes, batches = FITS[name]
    sym = pkg.models.get_symbol(name, num_classes=classes, **kwargs)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch * batches,) + shape).astype(np.float32)
    y = rng.randint(0, classes, batch * batches).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    init = pkg.initializer.Xavier(factor_type="in", magnitude=2)
    mod.init_params(init)
    start = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    aux0 = {k: v.asnumpy().copy() for k, v in mod.get_params()[1].items()}
    metrics = []
    callbacks = [lambda p: metrics.append(p.eval_metric.get_name_value())]
    if record_speed:
        callbacks.append(pkg.callback.Speedometer(batch, frequent=1))
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9),
                              ("wd", 1e-4)),
            initializer=init, eval_metric=["acc", "ce"],
            batch_end_callback=callbacks)
    args, aux = mod.get_params()
    return (mod, start, aux0, {k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()}, metrics, it)


def _metric_values(metrics):
    return np.array([[float(v) for _, v in m] for m in metrics])


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_module_fit_matches_jax(name):
    got = _fit(mt, name)
    want = _fit(mx, name)
    for k, w in want[3].items():
        np.testing.assert_allclose(got[3][k], w, err_msg=k, **TOL)
    np.testing.assert_allclose(_metric_values(got[5]),
                               _metric_values(want[5]), **TOL)
    # scoring and prediction on the trained module
    (gmod, git), (wmod, wit) = (got[0], got[6]), (want[0], want[6])
    np.testing.assert_allclose(
        [v for _, v in gmod.score(git, "ce")],
        [v for _, v in wmod.score(wit, "ce")], **TOL)
    np.testing.assert_allclose(gmod.predict(git).asnumpy(),
                               wmod.predict(wit).asnumpy(), **TOL)


def test_module_fit_resnet18_matches_jax():
    _, g0, gx0, gp, gx, gm, _ = _fit(mt, "resnet-18")
    _, w0, wx0, wp, wx, wm, _ = _fit(mx, "resnet-18")
    assert set(gp) == set(wp) and len(gp) == 59 and len(gx) == 36
    for k in wp:
        np.testing.assert_array_equal(g0[k], w0[k])
        err = change_err(gp[k] - g0[k], wp[k] - w0[k])
        assert err <= 2e-2, (k, err)
    for k in wx:
        err = change_err(gx[k] - gx0[k], wx[k] - wx0[k])
        assert err <= 1e-3, (k, err)
    np.testing.assert_allclose(_metric_values(gm), _metric_values(wm),
                               rtol=1e-4, atol=1e-6)


def test_module_fit_runs_callbacks_and_updates_every_parameter(caplog):
    caplog.set_level(logging.INFO)
    mod, start, _, params, _, metrics, _ = _fit(mt, "mlp", True)
    assert len(metrics) == 3
    assert all(not np.array_equal(start[k], params[k]) for k in params)
    assert "samples/sec" in caplog.text


def test_module_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """Without a card a Module needs the CPU named; two CPU contexts bind
    (one executor each), and a dist_sync store without a launcher is one
    worker's, as the JAX package's."""
    sym = mt.models.get_symbol("mlp", num_classes=3, hidden=(4,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.mod.Module(sym)
    two = mt.mod.Module(sym, context=["cpu", "cpu"])
    two.bind([("data", (2, 5))], [("softmax_label", (2,))])
    assert len(two._exec_group.execs) == 2
    mod = mt.mod.Module(sym, context="cpu")
    mod.bind([("data", (2, 5))], [("softmax_label", (2,))])
    mod.init_params()
    mod.init_optimizer(kvstore="dist_sync")
    assert type(mod._kvstore) is mt.kvstore.KVStore
    assert (mod._kvstore.type, mod._kvstore.rank,
            mod._kvstore.num_workers) == ("dist_sync", 0, 1)
    assert mod._update_on_kvstore
    jmod = mx.mod.Module(mx.models.get_symbol("mlp", num_classes=3,
                                              hidden=(4,)), context=mx.cpu())
    jmod.bind([("data", (2, 5))], [("softmax_label", (2,))])
    jmod.init_params()
    jmod.init_optimizer(kvstore="dist_sync")
    assert (jmod._kvstore.rank, jmod._kvstore.num_workers,
            jmod._update_on_kvstore) == (0, 1, True)


def test_module_input_grads_and_fixed_params():
    sym = mt.models.get_symbol("mlp", num_classes=3, hidden=(4,))
    mod = mt.mod.Module(sym, context="cpu", fixed_param_names=["fc1_bias"])
    mod.bind([("data", (2, 5))], [("softmax_label", (2,))],
             inputs_need_grad=True)
    # its own generator, at a draw with live hidden units: a draw where
    # every ReLU is dead has a true zero input gradient
    mod.init_params(mt.initializer.Uniform(
        0.5, rng=np.random.RandomState(0)))
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
    args = mod.get_params()[0]
    hidden = (np.ones((1, 5)) @ args["fc1_weight"].asnumpy().T
              + args["fc1_bias"].asnumpy())
    assert (hidden > 0).any()
    before = args["fc1_bias"].asnumpy().copy()
    batch = mt.io.DataBatch([mt.nd.array(np.ones((2, 5)), "cpu")],
                            [mt.nd.array(np.array([0.0, 2.0]), "cpu")])
    mod.forward_backward(batch)
    mod.update()
    (dx,) = mod.get_input_grads()
    assert dx.shape == (2, 5) and np.abs(dx.asnumpy()).sum() > 0
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_bias"].asnumpy(),
                                  before)
