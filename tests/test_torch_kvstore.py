"""mxnet_tpu_torch's KVStore and Module over several contexts against the
JAX package, on the CPU.

- The KVStore: each subject of ``tests/test_kvstore.py`` (and duplicate
  keys grouped in one call) as one scenario run by both packages on the
  same numpy inputs: exact, or within 1e-6 where an updater runs. An
  optimizer-state file written by either store loads into the other.
- ``Module`` over two contexts: the port over ``["cpu", "cpu"]`` (two
  executors, each its half of the batch) against the JAX package over
  ``[mx.cpu(0), mx.cpu(1)]`` (one executor over a mesh of the eight CPU
  devices ``tests/conftest.py`` gives JAX), ``mlp`` and a 2-layer narrow
  LSTM LM, kvstores ``local`` and ``device``, the update on the kvstore
  and on the workers: 2 batches, every parameter within 1e-5 relative.
  The port's two contexts against its one. A ``normalization="batch"``
  head gives the JAX package's numbers; BatchNorm and a
  ``normalization="valid"`` head refuse to train over two contexts,
  naming the op.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.kvstore import KVStore as JaxKVStore
from mxnet_tpu_torch.base import MXNetError

SHAPE = (4, 4)


def _nd(pkg):
    """(array from numpy, zeros) on the CPU for ``pkg``."""
    if pkg is mt:
        return (lambda a: mt.nd.array(np.asarray(a, np.float32), ctx="cpu"),
                lambda shape: mt.nd.zeros(shape, "cpu"))
    return (lambda a: mx.nd.array(np.asarray(a, np.float32)),
            lambda shape: mx.nd.zeros(shape))


def _single_kv_pair(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init(3, arr(np.ones(SHAPE)))
    out = zeros(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _aggregate_push_pull(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init(3, zeros(SHAPE))
    rng = np.random.RandomState(1)
    kv.push(3, [arr(rng.randn(*SHAPE)) for _ in range(4)])
    out = zeros(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _updater_applied_on_push(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init(0, arr(np.ones(SHAPE)))

    def updater(key, grad, weight):
        weight -= 0.5 * grad

    kv.set_updater(updater)
    kv.push(0, arr(np.arange(16).reshape(SHAPE)))
    out = zeros(SHAPE)
    kv.pull(0, out=out)
    return [out.asnumpy()]


def _list_keys_and_multiple_pull_outs(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    keys = [5, 7, 9]
    kv.init(keys, [arr(np.ones(SHAPE))] * 3)
    kv.push(keys, [[arr(np.full(SHAPE, k / 2.0))] for k in keys])
    outs = [zeros(SHAPE) for _ in keys]
    kv.pull(keys, out=outs)
    # two outputs of one key
    two = [zeros(SHAPE), zeros(SHAPE)]
    kv.pull(7, out=two)
    return [o.asnumpy() for o in outs + two]


def _string_keys(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init("w", zeros(SHAPE))
    kv.push("w", arr(np.full(SHAPE, 3.0)))
    out = zeros(SHAPE)
    kv.pull("w", out=out)
    return [out.asnumpy()]


def _set_optimizer_runs_fused_update(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("device")
    kv.init(0, arr(np.ones(SHAPE)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       wd=1e-3))
    rng = np.random.RandomState(2)
    outs = []
    for _ in range(3):
        kv.push(0, [arr(rng.randn(*SHAPE)), arr(rng.randn(*SHAPE))])
        out = zeros(SHAPE)
        kv.pull(0, out=out)
        outs.append(out.asnumpy())
    return outs


def _rank_and_size_local(pkg, tmp_path):
    out = []
    for kind in ("local", "device", "dist_sync", "dist_async"):
        kv = pkg.kvstore.create(kind)
        out.append(np.array([kv.rank, kv.num_workers, kv.num_dead_node()]))
    return out


def _optimizer_state_save_load(pkg, tmp_path):
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init(0, arr(np.ones(SHAPE)))
    kv.set_optimizer(pkg.optimizer.Adam(learning_rate=0.01))
    kv.push(0, arr(np.ones(SHAPE)))
    f = str(tmp_path / ("states-%s" % pkg.__name__))
    kv.save_optimizer_states(f)
    cur = zeros(SHAPE)
    kv.pull(0, out=cur)
    kv2 = pkg.kvstore.create("local")
    kv2.init(0, cur)
    kv2.set_optimizer(pkg.optimizer.Adam(learning_rate=0.01))
    kv2.load_optimizer_states(f)
    kv.push(0, arr(np.ones(SHAPE)))
    kv2.push(0, arr(np.ones(SHAPE)))
    a, b = zeros(SHAPE), zeros(SHAPE)
    kv.pull(0, out=a)
    kv2.pull(0, out=b)
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    return [a.asnumpy()]


def _grouped_duplicate_keys(pkg, tmp_path):
    """Duplicate keys in one push merge all their values (reference
    GroupKVPairs); duplicate pull outputs each get the value."""
    arr, zeros = _nd(pkg)
    kv = pkg.kvstore.create("local")
    kv.init([1, 2], [zeros(SHAPE), zeros(SHAPE)])
    kv.push([1, 2, 1], [arr(np.full(SHAPE, 1.0)), arr(np.full(SHAPE, 5.0)),
                        [arr(np.full(SHAPE, 2.0)), arr(np.full(SHAPE, 4.0))]])
    outs = [zeros(SHAPE) for _ in range(3)]
    kv.pull([1, 2, 1], out=outs)
    return [o.asnumpy() for o in outs]


SCENARIOS = {
    "single_kv_pair": (_single_kv_pair, 0),
    "aggregate_push_pull": (_aggregate_push_pull, 0),
    "updater_applied_on_push": (_updater_applied_on_push, 0),
    "list_keys_and_multiple_pull_outs": (_list_keys_and_multiple_pull_outs,
                                         0),
    "string_keys": (_string_keys, 0),
    "set_optimizer_runs_fused_update": (_set_optimizer_runs_fused_update,
                                        1e-6),
    "rank_and_size_local": (_rank_and_size_local, 0),
    "optimizer_state_save_load": (_optimizer_state_save_load, 1e-6),
    "grouped_duplicate_keys": (_grouped_duplicate_keys, 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_kvstore_matches_jax(name, tmp_path):
    fn, rtol = SCENARIOS[name]
    got, want = fn(mt, tmp_path), fn(mx, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)


def _push_rounds(pkg, kv, rounds, seed):
    arr, zeros = _nd(pkg)
    rng = np.random.RandomState(seed)
    out = zeros(SHAPE)
    for _ in range(rounds):
        kv.push(0, arr(rng.randn(*SHAPE)))
    kv.pull(0, out=out)
    return out.asnumpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_state_files_cross_between_packages(writer, tmp_path):
    """Adam's states (and update counts) saved by one package's store load
    into the other's, which then steps as the writer would."""
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    f = str(tmp_path / "states")
    kvs = {}
    for pkg in (src, dst):
        arr, _ = _nd(pkg)
        kv = pkg.kvstore.create("local")
        kv.init(0, arr(np.ones(SHAPE)))
        kv.set_optimizer(pkg.optimizer.Adam(learning_rate=0.01))
        kvs[pkg] = kv
    start = _push_rounds(src, kvs[src], 2, seed=3)
    kvs[src].save_optimizer_states(f)
    arr, _ = _nd(dst)
    fresh = dst.kvstore.create("local")
    fresh.init(0, arr(start))
    fresh.set_optimizer(dst.optimizer.Adam(learning_rate=0.01))
    fresh.load_optimizer_states(f)
    want = _push_rounds(src, kvs[src], 1, seed=4)
    got = _push_rounds(dst, fresh, 1, seed=4)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_push_copies_and_pull_never_aliases():
    """A store without an updater keeps a copy of what was pushed, and a
    pull writes into the output's own tensor: later writes to either side
    do not reach the other."""
    kv = mt.kvstore.create("local")
    g = mt.nd.array(np.ones(SHAPE), ctx="cpu")
    kv.push(0, g)
    out = mt.nd.zeros(SHAPE, "cpu")
    t = out._data
    kv.pull(0, out=out)
    assert out._data is t
    g[:] = 7.0
    out[:] = 9.0
    again = mt.nd.zeros(SHAPE, "cpu")
    kv.pull(0, out=again)
    np.testing.assert_array_equal(again.asnumpy(), np.ones(SHAPE))


def test_kvstore_counters_and_spans():
    """The five counters rise by the keys and bytes moved; push, pull and
    barrier spans are emitted in the kvstore domain."""
    from mxnet_tpu_torch import telemetry

    def counts():
        return {n: v for n, v in telemetry.registry.get_name_value()
                if n.startswith("kvstore_")}

    before = counts()
    telemetry.enable_spans("kvstore")
    telemetry.drain_events()
    try:
        kv = mt.kvstore.create("device")
        kv.init([0, 1], [mt.nd.zeros(SHAPE, "cpu")] * 2)
        kv.push([0, 1], [[mt.nd.ones(SHAPE, "cpu")] * 2,
                         mt.nd.ones(SHAPE, "cpu")])
        kv.pull([0, 1], out=[[mt.nd.zeros(SHAPE, "cpu")] * 3,
                             mt.nd.zeros(SHAPE, "cpu")])
        kv.barrier()
        names = [e[1] for e in telemetry.drain_events()]
    finally:
        telemetry.disable_spans()
    rise = {n: v - before.get(n, 0) for n, v in counts().items()}
    assert rise == {"kvstore_push_total": 2,
                    "kvstore_push_bytes_total": 2 * 64,
                    "kvstore_pull_total": 2,
                    "kvstore_pull_bytes_total": 4 * 64,
                    "kvstore_barrier_total": 1}
    assert names.count("kvstore.push") == 1
    assert names.count("kvstore.pull") == 1


def test_create_refuses_unknown_types_as_jax():
    for pkg in (mt, mx):
        with pytest.raises(pkg.base.MXNetError, match="unknown kvstore"):
            pkg.kvstore.create("nope")
        with pytest.raises(TypeError):
            pkg.kvstore.create(3)
    for kind in mt.kvstore.TYPES:
        assert isinstance(mx.kvstore.create(kind), JaxKVStore)
        assert type(mt.kvstore.create(kind)) is mt.kvstore.KVStore


# --- Module over several contexts -------------------------------------------
MLP = {"num_classes": 6, "hidden": (16, 8)}
LM = {"num_classes": 50, "seq_len": 5, "num_embed": 16, "num_hidden": 16,
      "num_layers": 2, "fused": True}


def _model(pkg, name):
    """(symbol, x, y, eval metric) of the model ``name`` at batch 8 x 2."""
    rng = np.random.RandomState(0)
    if name == "mlp":
        x = rng.uniform(-1, 1, (16, 10)).astype(np.float32)
        y = rng.randint(0, 6, 16).astype(np.float32)
        return pkg.models.get_symbol("mlp", **MLP), x, y, "acc"
    x = rng.randint(0, 50, (16, 5)).astype(np.float32)
    y = rng.randint(0, 50, (16, 5)).astype(np.float32)
    return (pkg.models.get_symbol("lstm-lm", **LM), x, y,
            pkg.metric.Perplexity(None))


def _contexts(pkg, k):
    if pkg is mt:
        return ["cpu"] * k
    return [mx.cpu(i) for i in range(k)]


def _fit(pkg, name, k, kvstore, on_kvstore=None, monkeypatch=None,
         symbol=None):
    """Module.fit of ``name`` over ``k`` contexts for 2 batches of 8 from
    one seeded Xavier draw; (states after each batch, metrics)."""
    sym, x, y, metric = _model(pkg, name)
    if symbol is not None:
        sym = symbol(pkg)
    if on_kvstore is not None:
        # the update's placement, forced (a parameter over 16 M elements
        # would pick the workers for a "local" store)
        mod_ns = pkg.module.module
        real = mod_ns._create_kvstore

        def placed(kv, num_device, arg_params):
            store, _ = real(kv, num_device, arg_params)
            return store, on_kvstore and store is not None

        monkeypatch.setattr(mod_ns, "_create_kvstore", placed)
    it = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod = pkg.mod.Module(sym, context=_contexts(pkg, k))
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    init = pkg.initializer.Xavier()
    mod.init_params(init)
    states, metrics = [], []

    def record(param):
        states.append({n: v.asnumpy().copy()
                       for n, v in mod.get_params()[0].items()})
        metrics.append(param.eval_metric.get_name_value()[0][1])

    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9),
                              ("wd", 1e-4)),
            initializer=init, eval_metric=metric,
            batch_end_callback=record)
    if on_kvstore is not None:
        monkeypatch.undo()
    return mod, states, metrics


def _close(got, want, rtol=1e-5):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for n in w:
            np.testing.assert_allclose(g[n], w[n], rtol=rtol,
                                       atol=rtol * np.abs(w[n]).max(),
                                       err_msg=n)


@pytest.mark.parametrize("on_kvstore", [True, False])
@pytest.mark.parametrize("kvstore", ["local", "device"])
@pytest.mark.parametrize("name", ["mlp", "lstm-lm"])
def test_module_two_contexts_matches_jax(name, kvstore, on_kvstore,
                                         monkeypatch):
    gmod, got, gm = _fit(mt, name, 2, kvstore, on_kvstore, monkeypatch)
    wmod, want, wm = _fit(mx, name, 2, kvstore, on_kvstore, monkeypatch)
    assert gmod._update_on_kvstore == wmod._update_on_kvstore == on_kvstore
    assert gmod.fit_step_stats() == {"path": "unfused",
                                     "reason": "a kvstore"}
    _close(got, want)
    np.testing.assert_allclose(gm, wm, rtol=1e-5)
    # every context holds the same parameters, bit for bit
    execs = gmod._exec_group.execs
    for n in gmod._exec_group.param_names:
        np.testing.assert_array_equal(execs[0].arg_dict[n].asnumpy(),
                                      execs[1].arg_dict[n].asnumpy())


@pytest.mark.parametrize("kvstore", ["local", None])
def test_module_two_contexts_matches_one_context(kvstore):
    """The port over two contexts against itself over one: with or without
    a kvstore the update sums both slices' gradients."""
    gmod, got, gm = _fit(mt, "mlp", 2, kvstore)
    _, want, wm = _fit(mt, "mlp", 1, kvstore)
    _close(got, want)
    np.testing.assert_allclose(gm, wm, rtol=1e-6)
    assert gmod.fit_step_stats()["reason"] == (
        "a kvstore" if kvstore else "several contexts")


def _head(norm):
    def build(pkg):
        data = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = pkg.sym.Activation(h, act_type="tanh")
        h = pkg.sym.FullyConnected(h, num_hidden=6, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax", normalization=norm)
    return build


def test_batch_normalized_head_over_two_contexts_matches_jax():
    """A normalization="batch" head divides by the whole batch in the JAX
    package's mesh executor; the port tells each slice's head its share,
    which gives the same numbers."""
    _, got, gm = _fit(mt, "mlp", 2, "device", symbol=_head("batch"))
    _, want, wm = _fit(mx, "mlp", 2, "device", symbol=_head("batch"))
    _close(got, want)
    np.testing.assert_allclose(gm, wm, rtol=1e-6)


def test_ops_that_couple_rows_refuse_several_contexts():
    """BatchNorm's batch statistics and a normalization="valid" head need
    the whole batch: training over two contexts raises, naming the op; a
    bind for inference, or over one context, goes through."""
    sym = mt.models.get_symbol("resnet", num_classes=4, num_layers=18,
                               image_shape=(3, 8, 8))
    shapes = ([("data", (4, 3, 8, 8))], [("softmax_label", (4,))])
    mod = mt.mod.Module(sym, context=["cpu", "cpu"])
    with pytest.raises(MXNetError, match="BatchNorm"):
        mod.bind(*shapes)
    mod = mt.mod.Module(sym, context=["cpu", "cpu"])
    mod.bind(*shapes, for_training=False)
    mod = mt.mod.Module(_head("valid")(mt), context=["cpu", "cpu"])
    with pytest.raises(MXNetError, match="SoftmaxOutput .*valid"):
        mod.bind([("data", (4, 10))], [("softmax_label", (4,))])
    mod = mt.mod.Module(_head("valid")(mt), context="cpu")
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))])


def test_outputs_and_input_grads_merge_the_slices():
    """get_outputs / get_input_grads over two contexts are the whole
    batch's, as over one."""
    sym, x, y, _ = _model(mt, "mlp")
    batch = mt.io.DataBatch([mt.nd.array(x[:8], ctx="cpu")],
                            [mt.nd.array(y[:8], ctx="cpu")])
    res = []
    for k in (1, 2):
        mod = mt.mod.Module(sym, context=["cpu"] * k)
        mod.bind([("data", (8, 10))], [("softmax_label", (8,))],
                 inputs_need_grad=True)
        np.random.seed(1)
        mod.init_params(mt.initializer.Xavier())
        mod.forward_backward(batch)
        res.append((mod.get_outputs()[0].asnumpy(),
                    mod.get_input_grads()[0].asnumpy()))
        if k == 2:
            parts = mod.get_outputs(merge_multi_context=False)
            assert [p.shape for p in parts[0]] == [(4, 6), (4, 6)]
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_module_optimizer_states_through_the_kvstore(tmp_path):
    """With the update on the kvstore, Module's optimizer-state file is
    the kvstore's updater's, and loading it restores the momentum."""
    mod, _, _ = _fit(mt, "mlp", 2, "device")
    f = str(tmp_path / "m.states")
    mod.save_optimizer_states(f)
    states = mod._kvstore._updater.states
    mod.load_optimizer_states(f)
    for k, v in states.items():
        np.testing.assert_array_equal(
            mod._kvstore._updater.states[k].asnumpy(), v.asnumpy())


def test_bucketing_module_two_contexts_matches_one():
    """BucketingModule passes the kvstore through: its buckets bound over
    two contexts (each bucket's executors on the shared tensors of the
    same context) train through one "device" store as one context does
    without one."""
    from mxnet_tpu_torch.tools import lstm_bucketing as lb

    cfg = dict(lb.BUCKETING, vocab=50, embed=16, hidden=16, buckets=(4, 8),
               batch=4, sentences=200)
    keys = (4, 8, 8, 4)
    runs = []
    for contexts, kvstore in ((["cpu", "cpu"], "device"), ("cpu", None)):
        mod, init = lb.bucketing_module(cfg, contexts, 0.0, cfg["batch"])
        mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params=lb.optimizer_params(cfg))
        batches = lb.pick_batches(lb.bucket_iter(cfg, cfg["batch"], 3), keys)
        for b in batches.batches:
            mod.fit_step(b)
        runs.append({n: v.asnumpy() for n, v in mod.get_params()[0].items()})
        if kvstore:
            assert lb.master_module(mod)._kvstore.type == "device"
    for n in runs[1]:
        np.testing.assert_allclose(runs[0][n], runs[1][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
