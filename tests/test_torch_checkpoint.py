"""Checkpoints of mxnet_tpu_torch against the JAX package, on the CPU:
``nd.save`` / ``nd.load`` (npz and the reference's ``.params`` blob), the
symbol's JSON (both schemas), the optimizer-state blob and the
``Module`` / ``model`` / ``callback`` / ``rnn`` checkpoints, each written
by one package and read by the other.

Arrays cross exactly (f32 written and read back). The symbols' JSON is
equal as parsed JSON, and each package builds the other's graph. A
module that resumes in the other package from a checkpoint with its
optimizer states goes on to the writer's own continued parameters
within rtol / atol 1e-6 (the same two f32 steps in both packages, other
summation orders in the products).
"""
import json
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

STEP_TOL = {"rtol": 1e-6, "atol": 1e-6}
CTX = {mt: "cpu", mx: None}
OPTIMIZERS = {"sgd": (("learning_rate", 0.1), ("momentum", 0.9),
                      ("wd", 1e-3)),
              "adam": (("learning_rate", 0.01), ("wd", 1e-3))}


def _arrays():
    rng = np.random.RandomState(0)
    return {"arg:w": rng.randn(3, 4).astype(np.float32),
            "aux:m": rng.randn(5).astype(np.float32),
            "arg:i": np.arange(6, dtype=np.int32).reshape(2, 3)}


@pytest.mark.parametrize("fmt", ["npz", "reference"])
@pytest.mark.parametrize("form", ["dict", "list"])
@pytest.mark.parametrize("writer,reader", [(mt, mx), (mx, mt), (mt, mt)])
def test_nd_save_load_round_trips_across_packages(tmp_path, writer, reader,
                                                  form, fmt):
    vals = _arrays()
    nds = {k: writer.nd.array(v, ctx=CTX[writer], dtype=v.dtype)
           for k, v in vals.items()}
    fname = str(tmp_path / "x.params")
    writer.nd.save(fname, nds if form == "dict" else list(nds.values()),
                   format=fmt)
    assert os.path.exists(fname) and not os.path.exists(fname + ".npz")
    got = reader.nd.load(fname)
    if form == "list":
        assert isinstance(got, list) and len(got) == len(vals)
        got = dict(zip(vals, got))
    assert sorted(got) == sorted(vals)
    for k, v in vals.items():
        a = got[k].asnumpy()
        assert a.dtype == v.dtype
        np.testing.assert_array_equal(a, v)


def test_nd_load_puts_arrays_on_the_host(tmp_path):
    fname = str(tmp_path / "y")
    mt.nd.save(fname, [mt.nd.array([1.0, 2.0], ctx="cpu")])
    (a,) = mt.nd.load(fname)
    assert str(a.context) == "cpu"


MODELS = {
    "lenet": dict(num_classes=10),
    "resnet": dict(num_classes=10, num_layers=18, image_shape=(3, 32, 32)),
    "transformer-lm": dict(vocab_size=50, num_layers=1, d_model=16,
                           num_heads=2, seq_len=8),
    "lstm-bucket-4": dict(num_classes=50, seq_len=4, num_embed=16,
                          num_hidden=16, num_layers=2, dropout=0.5,
                          fused=True),
    "lstm-bucket-8": dict(num_classes=50, seq_len=8, num_embed=16,
                          num_hidden=16, num_layers=2, dropout=0.5,
                          fused=True),
}


def _model(pkg, key):
    name = "lstm-lm" if key.startswith("lstm") else key
    with pkg.name.NameManager():
        return pkg.models.get_symbol(name, **MODELS[key])


@pytest.mark.parametrize("fmt", ["native", "reference"])
@pytest.mark.parametrize("key", sorted(MODELS))
def test_symbol_json_equals_jax_and_builds_in_both(key, fmt):
    ours, theirs = _model(mt, key), _model(mx, key)
    got, want = ours.tojson(fmt), theirs.tojson(fmt)
    assert json.loads(got) == json.loads(want)
    # each package reads the other's JSON into the graph the writer reads
    # it into (a reference "null" enum comes back as "None" in both)
    from_jax = mt.sym.load_json(want)
    from_port = mx.sym.load_json(got)
    assert json.loads(from_jax.tojson(fmt)) == json.loads(
        mx.sym.load_json(want).tojson(fmt))
    assert json.loads(from_port.tojson(fmt)) == json.loads(
        mt.sym.load_json(got).tojson(fmt))
    assert from_jax.list_arguments() == theirs.list_arguments()
    assert from_jax.list_auxiliary_states() == \
        theirs.list_auxiliary_states()
    assert from_jax.list_outputs() == theirs.list_outputs()


def test_a_loaded_graph_computes_what_the_written_one_does(tmp_path):
    """LeNet written by the JAX package, loaded by the port: the same
    forward on the same weights as the port's own LeNet, within rtol 1e-5
    / atol 5e-6 (the same graph, but PyTorch's CPU convolution picks its
    kernel by the buffers' alignment, so two binds can differ in the
    last bits)."""
    fname = str(tmp_path / "lenet-symbol.json")
    _model(mx, "lenet").save(fname)
    loaded = mt.sym.load(fname)
    own = _model(mt, "lenet")
    outs = []
    for sym in (loaded, own):
        exe = sym.simple_bind("cpu", data=(2, 1, 28, 28))
        rng = np.random.RandomState(3)
        for n, a in sorted(exe.arg_dict.items()):
            a[:] = rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        outs.append(exe.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=5e-6)


# --- Module checkpoints across the packages ----------------------------------
def _mlp(pkg):
    with pkg.name.NameManager():
        return pkg.models.get_symbol("mlp", num_classes=3, hidden=(8,))


def _batches(pkg, n):
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (4 * n, 5)).astype(np.float32)
    y = rng.randint(0, 3, 4 * n).astype(np.float32)
    return list(pkg.io.NDArrayIter(x, y, batch_size=4))


def _weights(pkg):
    sym = _mlp(mt)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(4, 5))[0]))
    rng = np.random.RandomState(6)
    return {n: pkg.nd.array(rng.uniform(-0.5, 0.5, s).astype(np.float32),
                            ctx=CTX[pkg])
            for n, s in shapes.items() if n not in ("data",
                                                    "softmax_label")}


def _module(pkg, opt):
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(arg_params=_weights(pkg), aux_params={})
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
    return mod


def _params(mod):
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("writer,reader", [(mx, mt), (mt, mx)])
def test_module_resumes_across_packages(tmp_path, writer, reader, opt):
    prefix = str(tmp_path / "ck")
    mod = _module(writer, opt)
    for b in _batches(writer, 2):
        mod.fit_step(b)
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    for b in _batches(writer, 4)[2:]:
        mod.fit_step(b)
    want = _params(mod)

    kw = {"context": reader.cpu()}
    resumed = reader.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                     **kw)
    resumed.bind([("data", (4, 5))], [("softmax_label", (4,))])
    resumed.init_optimizer(optimizer=opt, optimizer_params=OPTIMIZERS[opt])
    for b in _batches(reader, 4)[2:]:
        resumed.fit_step(b)
    got = _params(resumed)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **STEP_TOL)


def test_fused_module_saves_the_stepped_parameters_and_states(tmp_path):
    prefix = str(tmp_path / "f")
    mod = _module(mt, "sgd")
    for b in _batches(mt, 3):
        mod.fit_step(b)
    assert mod.fit_step_stats()["path"] == "eager"
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    _, args, _ = mt.model.load_checkpoint(prefix, 3)
    live = _params(mod)
    for n in live:
        np.testing.assert_array_equal(args[n].asnumpy(), live[n])
    # the state blob holds the step's momentum buffers, not zeros
    with open(prefix + "-0003.states", "rb") as f:
        blob = pickle.load(f)
    step_states = mod._fused_fit["update"].states(
        mod._exec_group._exec.arg_dict)
    for i, n in enumerate(mod._exec_group.param_names):
        np.testing.assert_array_equal(blob[i], step_states[n].numpy())
        assert np.abs(blob[i]).max() > 0
    assert blob["__update_counts__"] == {i: 3 for i in range(4)}


def test_loading_optimizer_states_drops_the_fused_step(tmp_path):
    prefix = str(tmp_path / "d")
    mod = _module(mt, "sgd")
    for b in _batches(mt, 2):
        mod.fit_step(b)
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    first = mod._fused_fit["step"]
    mod.load_optimizer_states(prefix + "-0002.states")
    assert mod._fused_fit is None
    loaded = {i: s.asnumpy() for i, s in mod._updater.states.items()}
    batch = _batches(mt, 3)[2]
    mod.fit_step(batch)
    assert mod._fused_fit["step"] is not first
    # the rebuilt step updates the loaded state tensors in place
    for i, s in mod._updater.states.items():
        assert not np.array_equal(s.asnumpy(), loaded[i])
    # and lands where an unfused module resumed from the same files does
    twin = mt.mod.Module.load(prefix, 2, load_optimizer_states=True,
                              context="cpu")
    twin.bind([("data", (4, 5))], [("softmax_label", (4,))])
    twin.init_optimizer(optimizer="sgd", optimizer_params=OPTIMIZERS["sgd"])
    os.environ["MXNET_FUSED_FIT"] = "0"
    try:
        twin.fit_step(batch)
    finally:
        del os.environ["MXNET_FUSED_FIT"]
    assert twin.fit_step_stats()["path"] == "unfused"
    want, got = _params(twin), _params(mod)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_async_checkpoint_is_read_after_it_is_written(tmp_path):
    prefix = str(tmp_path / "a")
    mod = _module(mt, "sgd")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True,
                        async_write=True)
    sym, args, aux = mt.model.load_checkpoint(prefix, 1)
    mt.engine.wait_for_file(prefix + "-0001.states")
    assert sorted(args) == sorted(_params(mod))
    assert sym.list_arguments() == mod.symbol.list_arguments()


def test_a_failed_write_raises_at_the_wait(tmp_path):
    def fail():
        raise OSError("disk full")

    path = str(tmp_path / "bad")
    mt.engine.push_file_write(path, fail, wait=False)
    with pytest.raises(OSError, match="disk full"):
        mt.engine.wait_for_file(path)


def test_checkpoint_callbacks_write_both_files(tmp_path):
    mod = _module(mt, "sgd")
    args, aux = mod.get_params()
    mt.callback.do_checkpoint(str(tmp_path / "m"), period=2)(
        1, mod.symbol, args, aux)
    mt.callback.module_checkpoint(mod, str(tmp_path / "n"),
                                  save_optimizer_states=True)(0)
    names = sorted(os.listdir(tmp_path))
    assert names == ["m-0002.params", "m-symbol.json", "n-0001.params",
                     "n-0001.states", "n-symbol.json"]
    _, got, _ = mx.model.load_checkpoint(str(tmp_path / "m"), 2)
    for n, a in args.items():
        np.testing.assert_array_equal(np.asarray(got[n].asnumpy()),
                                      a.asnumpy())


def _stack(pkg, fused):
    """The 2-layer LSTM of the lstm-lm symbol: the FusedRNNCell, or the
    unfused stack of LSTMCells (the JAX package's FusedRNNCell has no
    unpack_weights of its own, so only the port saves a fused one)."""
    h = MODELS["lstm-bucket-4"]["num_hidden"]
    if fused:
        return pkg.rnn.FusedRNNCell(h, num_layers=2, mode="lstm",
                                    prefix="lstm_")
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(h, prefix="lstm_l%d_" % i))
    return stack


@pytest.mark.parametrize("writer,reader,fused", [(mt, mx, False),
                                                 (mx, mt, False),
                                                 (mt, mt, True)])
def test_rnn_checkpoint_unpacks_the_cells_across_packages(
        tmp_path, writer, reader, fused):
    with writer.name.NameManager():
        sym = writer.models.get_symbol(
            "lstm-lm", **dict(MODELS["lstm-bucket-4"], fused=fused))
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(2, 4), softmax_label=(2, 4))[0]))
    rng = np.random.RandomState(1)
    args = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()
            if n not in ("data", "softmax_label")}
    prefix = str(tmp_path / "r")
    writer.rnn.save_rnn_checkpoint(
        _stack(writer, fused), prefix, 1, sym,
        {n: writer.nd.array(v, ctx=CTX[writer]) for n, v in args.items()},
        {})
    _, raw, _ = reader.model.load_checkpoint(prefix, 1)
    assert "lstm_l0_i2h_i_weight" in raw and \
        "lstm_parameters" not in raw and "lstm_l0_i2h_weight" not in raw
    _, got, _ = reader.rnn.load_rnn_checkpoint(_stack(reader, fused),
                                               prefix, 1)
    assert sorted(got) == sorted(args)
    for n, v in args.items():
        np.testing.assert_array_equal(got[n].asnumpy(), v)
