"""SequentialModule, PythonModule / PythonLossModule, Monitor, FeedForward,
the four Symbol methods and the top-level names, against the JAX package
on the CPU.

The runs are small (an MLP 5 -> 8 -> 3 at batch 4; the LSTM LM of
``tools/zoo.py`` at vocab 50, 16 / 16, seq 5, batch 2), each built by
both packages from the same numpy seeds (``tools/zoo.py`` takes the
package). Parameters and metrics agree within f32 rounding: rtol 1e-5,
atol 1e-6 on the parameters, 1e-5 relative on the metrics and Monitor's
statistics; the Monitor reports the same names on the same batches.
"""
import copy
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.tools import zoo

RTOL, ATOL = 1e-5, 1e-6
TINY = dict(zoo.ZOO, vocab=50, embed=16, hidden=16, seq=5)
BATCH, BATCHES = 2, 3


def _mlp(pkg, part=None):
    sym = pkg.sym
    d = sym.Variable("data")
    h = sym.Activation(sym.FullyConnected(data=d, num_hidden=8, name="fc1"),
                       act_type="relu", name="relu1")
    if part == "body":
        return h
    if part == "head":
        h = sym.Variable("data")
    h = sym.FullyConnected(data=h, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(data=h, name="softmax")


def _ctx(pkg):
    return {"context": "cpu"} if pkg is mt else {}


def _mlp_iter(pkg):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4 * BATCHES, 5)).astype(np.float32)
    y = rng.randint(0, 3, 4 * BATCHES).astype(np.float32)
    return pkg.io.NDArrayIter(x, y, batch_size=4)


def _init(pkg, seed=1):
    if pkg is mt:
        return mt.initializer.Xavier(rng=np.random.RandomState(seed))
    np.random.seed(seed)
    return mx.initializer.Xavier()


def _fit(mod, it, pkg, optimizer="sgd", params=(("learning_rate", 0.1),
                                                 ("momentum", 0.9)),
         metric="acc", **kw):
    metrics = []
    mod.fit(it, num_epoch=1, optimizer=optimizer, optimizer_params=params,
            initializer=_init(pkg), eval_metric=metric,
            batch_end_callback=lambda p: metrics.append(
                dict(p.eval_metric.get_name_value())), **kw)
    args, aux = mod.get_params()
    return {n: a.asnumpy() for n, a in args.items()}, metrics


def _close_params(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _close_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def _mlp_chain(pkg):
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(_mlp(pkg, "body"), label_names=None,
                           **_ctx(pkg)))
    seq.add(pkg.mod.Module(_mlp(pkg, "head"), **_ctx(pkg)),
            take_labels=True, auto_wiring=True)
    return seq


def test_sequential_mlp_equals_the_jax_package_and_the_single_module():
    runs = {pkg: _fit(_mlp_chain(pkg), _mlp_iter(pkg), pkg)
            for pkg in (mt, mx)}
    _close_params(runs[mt][0], runs[mx][0])
    _close_metrics(runs[mt][1], runs[mx][1])
    single = _fit(mt.mod.Module(_mlp(mt), **_ctx(mt)), _mlp_iter(mt), mt)
    _close_params(runs[mt][0], single[0])


def _lm_symbol(pkg):
    # a fresh NameManager: the generated names count from 0 in both
    with pkg.NameManager():
        return pkg.models.get_symbol(
            "lstm-lm", num_classes=TINY["vocab"], seq_len=TINY["seq"],
            num_embed=TINY["embed"], num_hidden=TINY["hidden"],
            num_layers=TINY["layers"], fused=True)


def _lm_fit(pkg, loss, single=False, run="sgd"):
    """One epoch of BATCHES batches of the LM chain of tools/zoo.py (or,
    with ``single``, of the LM as one Module): (parameters, metrics)."""
    ctx = "cpu" if pkg is mt else None
    mod = (pkg.mod.Module(_lm_symbol(pkg), **_ctx(pkg)) if single
           else zoo.chain(TINY, ctx, pkg=pkg, loss=loss))
    it = zoo.zoo_iter(TINY, BATCH, BATCHES, 1, pkg=pkg)
    metric = zoo.logit_perplexity(pkg) if loss else pkg.metric.Perplexity(
        ignore_label=None)
    kw = zoo.fit_args(TINY, _init(pkg), run, pkg=pkg, metric=metric,
                      batch=BATCH)
    metrics = []
    mod.fit(it, batch_end_callback=lambda p: metrics.append(
        dict(p.eval_metric.get_name_value())), **kw)
    args, _ = mod.get_params()
    return {n: a.asnumpy() for n, a in args.items()}, metrics


@pytest.mark.parametrize("loss", [False, True], ids=["softmax_head",
                                                     "python_loss_head"])
def test_sequential_lm_equals_the_jax_package(loss):
    """The LM chain of tools/zoo.py: body + FC + PythonLossModule against
    the JAX package's chain; body + SoftmaxOutput head against the JAX
    package's single Module (its SequentialModule infers a last module's
    output shapes from the data alone, and the head's label passes a
    Reshape, so it cannot bind this chain)."""
    got = _lm_fit(mt, loss)
    want = _lm_fit(mx, loss, single=not loss)
    _close_params(got[0], want[0])
    _close_metrics(got[1], want[1])


def test_python_loss_head_trains_as_the_softmax_head():
    """softmax - onehot is SoftmaxOutput's gradient: both chains land on
    the same parameters."""
    a, b = _lm_fit(mt, False), _lm_fit(mt, True)
    _close_params(a[0], b[0])


def test_sequential_module_refuses_what_the_reference_refuses():
    seq = mt.mod.SequentialModule()
    with pytest.raises(ValueError, match="Unknown meta"):
        seq.add(mt.mod.Module(_mlp(mt), **_ctx(mt)), take_label=True)
    with pytest.raises(mt.MXNetError, match="empty"):
        seq.bind([("data", (4, 5))])
    dup = mt.mod.SequentialModule()
    for _ in range(2):
        dup.add(mt.mod.Module(_mlp(mt, "body"), label_names=None,
                              **_ctx(mt)), auto_wiring=True)
    dup.bind([("data", (4, 5))], for_training=False)
    with pytest.raises(mt.MXNetError, match="Duplicated parameter names"):
        dup.init_params()
    loss = mt.mod.PythonLossModule()
    loss.bind([("data", (4, 3))], [("softmax_label", (4,))])
    assert loss.output_shapes == [("pyloss_output", (4, 3))]
    assert loss.get_params() == ({}, {})
    with pytest.raises(NotImplementedError):
        loss.backward()


def _monitored(pkg, make_mod, make_iter, batches):
    mod = make_mod(pkg)
    mon = pkg.Monitor(2, pattern=".*", sort=False)
    reports = []
    toc = mon.toc

    def recorded():
        out = toc()
        reports.append(out)
        return out

    mon.toc = recorded
    _fit(mod, make_iter(pkg), pkg, monitor=mon,
         metric="acc" if batches else pkg.metric.Perplexity(None))
    return reports, mod


@pytest.mark.parametrize("model", ["mlp", "lstm"])
def test_monitor_reports_what_the_jax_packages_reports(model):
    if model == "mlp":
        def make_mod(pkg):
            return pkg.mod.Module(_mlp(pkg), **_ctx(pkg))

        make_iter, n = _mlp_iter, BATCHES
    else:
        def make_mod(pkg):
            return pkg.mod.Module(_lm_symbol(pkg), **_ctx(pkg))

        def make_iter(pkg):
            return zoo.zoo_iter(TINY, BATCH, 3, 1, pkg=pkg)

        n = 0
    got, mod = _monitored(mt, make_mod, make_iter, n)
    want, _ = _monitored(mx, make_mod, make_iter, n)
    assert [bool(r) for r in got] == [bool(r) for r in want] == [
        k % 2 == 0 for k in range(len(got))]
    for g, w in zip(got, want):
        assert [x[:2] for x in g] == [x[:2] for x in w]
        np.testing.assert_allclose([float(x[2]) for x in g],
                                   [float(x[2]) for x in w], rtol=1e-5)
    # every internal output and argument, on each monitored batch
    names = (mod.symbol.get_internals().list_outputs()
             + mod.symbol.list_arguments())
    assert [x[1] for x in got[0]] == names
    assert mod.fit_step_stats() == {"path": "unfused",
                                    "reason": "monitor install"}


def test_monitor_spans_and_bucketing_install(caplog):
    from mxnet_tpu_torch import telemetry

    mon = mt.Monitor(1, pattern="fc1.*")
    mod = mt.mod.Module(_mlp(mt), **_ctx(mt))
    telemetry.enable_spans("monitor")
    try:
        telemetry.drain_events()
        with caplog.at_level(logging.INFO):
            _fit(mod, _mlp_iter(mt), mt, monitor=mon)
        # (ph, name, domain, ...) tuples
        names = [e[1] for e in telemetry.drain_events() if e[2] == "monitor"]
    finally:
        telemetry.disable_spans()
    assert names.count("monitor.drain") == 2 * BATCHES
    # fc1_weight, fc1_bias, fc1_output a forward, then the two arguments
    assert names.count("monitor.stat") == 5 * BATCHES
    assert sum("Batch:" in r.getMessage() for r in caplog.records) == \
        5 * BATCHES

    def gen(key):
        return _mlp(mt), ("data",), ("softmax_label",)

    bm = mt.mod.BucketingModule(gen, default_bucket_key=4, context="cpu")
    bm.bind([("data", (4, 5))], [("softmax_label", (4,))])
    bm.install_monitor(mt.Monitor(1))
    assert bm._buckets[4]._monitor_installed


def _ff_data():
    from mxnet_tpu_torch.tools.lstm_lm import lstm_data

    return lstm_data(TINY, BATCH, 2, 1)


def _feedforward(pkg):
    x, y = _ff_data()
    sym = _lm_symbol(pkg)
    kw = {"ctx": "cpu"} if pkg is mt else {}
    ff = pkg.model.FeedForward(sym, num_epoch=1, initializer=_init(pkg),
                               numpy_batch_size=BATCH, learning_rate=0.5,
                               momentum=0.9, **kw)
    ff.fit(x, y, eval_metric=pkg.metric.Perplexity(None))
    labelled = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    return (ff, ff.predict(labelled),
            ff.score(x, y, eval_metric=pkg.metric.Perplexity(None)))


def test_feedforward_equals_the_jax_package_and_crosses_by_checkpoint(
        tmp_path):
    (ff, pred, score), (jff, jpred, jscore) = _feedforward(mt), \
        _feedforward(mx)
    np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-7)
    assert abs(score - jscore) <= 1e-5 * jscore
    x, y = _ff_data()
    prefix = str(tmp_path / "ff")
    ff.save(prefix, 1)
    for pkg, kw in ((mt, {"ctx": "cpu"}), (mx, {})):
        loaded = pkg.model.FeedForward.load(prefix, 1,
                                            numpy_batch_size=BATCH, **kw)
        again = loaded.predict(pkg.io.NDArrayIter(x, y, batch_size=BATCH))
        if pkg is mt:
            assert np.array_equal(again, pred)
        else:
            np.testing.assert_allclose(again, pred, rtol=1e-5, atol=1e-7)
    assert mt.FeedForward is mt.model.FeedForward


def _grad_sym(pkg):
    x, w = pkg.sym.Variable("x"), pkg.sym.Variable("w")
    h = pkg.sym.FullyConnected(data=x, weight=w, num_hidden=3,
                               no_bias=True, name="fc")
    y = pkg.sym.Activation(data=h, act_type="tanh", name="act")
    return y * y + h, ["w", "x"]


def test_symbol_grad_equals_the_jax_package():
    rng = np.random.RandomState(6)
    vals = {"x": rng.randn(2, 4).astype(np.float32),
            "w": rng.randn(3, 4).astype(np.float32)}
    out = {}
    for pkg, kw in ((mt, {"ctx": "cpu"}), (mx, {})):
        s, wrt = _grad_sym(pkg)
        g = s.grad(wrt)
        assert g.list_arguments() == ["x", "w"]
        assert g.infer_shape(x=(2, 4), w=(3, 4))[1] == [(3, 4), (2, 4)]
        exe = g.simple_bind(kw.get("ctx", mx.cpu()), x=(2, 4), w=(3, 4),
                            grad_req="null")
        exe.forward(**{k: pkg.nd.array(v, **kw) for k, v in vals.items()})
        out[pkg] = [o.asnumpy() for o in exe.outputs]
    for a, b in zip(out[mt], out[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(mt.MXNetError, match="unknown arguments"):
        _grad_sym(mt)[0].grad("z")


def test_symbol_children_deepcopy_and_infer_type():
    for pkg in (mt, mx):
        s, _ = _grad_sym(pkg)
        kids = s.get_children()
        assert kids.list_outputs() == [
            x.list_outputs()[0] for x in kids] and len(kids) == 2
        assert pkg.sym.Variable("v").get_children() is None
        dup = copy.deepcopy(s)
        assert dup.tojson() == s.tojson() and dup is not s
    got = _grad_sym(mt)[0].infer_type(x="float32")
    want = _grad_sym(mx)[0].infer_type(x="float32")
    assert got == want and got[0] == [np.dtype("float32")] * 2
    assert mt.sym.Variable("a").infer_type() == ([None], [None], [])
    cast = mt.sym.Cast(mt.sym.Variable("a"), dtype="float16") if hasattr(
        mt.sym, "Cast") else None
    if cast is not None:
        assert cast.infer_type(a="float32")[1] == [np.dtype("float16")]


def test_top_level_names_of_the_jax_package_exist():
    names = ["AttrScope", "Context", "Executor", "FeedForward", "Group",
             "Monitor", "NameManager", "Prefix", "Variable", "cpu_pinned",
             "current_context", "init_registry", "monitor", "num_devices",
             "seed"]
    for n in names:
        assert hasattr(mx, n) and hasattr(mt, n), n
    assert not hasattr(mt, "tpu")      # the port's accelerator is gpu()
    assert mt.Variable("v").list_arguments() == ["v"]
    assert mt.Group([mt.Variable("a"), mt.Variable("b")]).list_outputs() \
        == ["a", "b"]
    ctx = mt.Context("cpu", 0)
    assert ctx == mt.Context(ctx) and str(ctx) == str(mx.Context("cpu", 0))
    assert mt.Context("gpu", 1).torch_device() == mt.gpu(1)
    assert mt.current_context() == mt.Context("gpu", 0)
    with mt.Context("cpu"):
        assert mt.current_context() == ctx
        assert mt.nd.zeros((2,)).context == mt.cpu()
    assert mt.cpu_pinned() == mt.cpu()
    assert mt.num_devices("cpu") == 1
    mt.seed(11)
    a = np.random.rand()
    mt.seed(11)
    assert np.random.rand() == a
    with mt.AttrScope(group="g"):
        assert mt.Variable("q").attr("group") == "g"
    with mt.Prefix("p_"):
        assert mt.sym.FullyConnected(mt.Variable("d"),
                                     num_hidden=2).name.startswith("p_")


def test_module_fit_takes_a_monitor_and_no_longer_raises():
    mod = mt.mod.Module(_mlp(mt), **_ctx(mt))
    _fit(mod, _mlp_iter(mt), mt, monitor=mt.Monitor(100))
    assert mod.fit_step_stats()["reason"] == "monitor install"
