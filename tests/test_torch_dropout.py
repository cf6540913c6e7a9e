"""Randomness in mxnet_tpu_torch against the JAX package, on the CPU:
``random.seed``, the ``Dropout`` op, the ``RNN`` op's dropout between
layers, ``DropoutCell`` / ``ZoneoutCell`` and the ``ones_like`` / ``where``
ops they build on.

The two packages draw from different generators (a torch Generator a
device here, a split JAX key there), so a training draw is held to its
definition, and to JAX wherever the draw can be taken out: eval mode is
the identity in both and equal exactly; in training each kept entry is
exactly x / (1 - p) and the gradient exactly dy / (1 - p) there (the
same f32 division on both sides), 0 elsewhere; the 2-layer RNN op at
p = 0.5 equals JAX's two 1-layer calls with the port's mask, drawn again
from a generator seeded the same way, applied between them (within rtol
/ atol 1e-5: f32 LSTM steps, other summation orders); the cells in eval
mode equal JAX's unroll within 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_fused as trnn

RNN_TOL = {"rtol": 1e-5, "atol": 1e-5}
CELL_TOL = {"rtol": 1e-6, "atol": 1e-6}
CTX = {mt: "cpu", mx: None}


def _x(shape=(6, 7), seed=0):
    return np.random.RandomState(seed).uniform(-2, 2, shape).astype(
        np.float32)


def _dropout_exe(pkg, x, p, mode="training"):
    net = pkg.sym.Dropout(pkg.sym.Variable("data"), p=p, mode=mode,
                          name="drop")
    exe = net.simple_bind(pkg.cpu(), data=x.shape)
    exe.arg_dict["data"][:] = x
    return exe


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_dropout_eval_is_the_identity_as_in_jax(p):
    x = _x()
    got = _dropout_exe(mt, x, p).forward(is_train=False)[0].asnumpy()
    want = _dropout_exe(mx, x, p).forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)
    imperative = mt.nd.Dropout(mt.nd.array(x, ctx="cpu"), p=p).asnumpy()
    np.testing.assert_array_equal(imperative, x)


@pytest.mark.parametrize("p,mode,is_train", [(0.5, "training", True),
                                             (0.3, "training", True),
                                             (0.5, "always", False)])
def test_dropout_in_training_keeps_x_over_keep_and_its_gradient(p, mode,
                                                                is_train):
    x = _x((64, 33))
    dy = _x((64, 33), seed=1)
    keep = 1.0 - p
    mt.random.seed(3)
    exe = _dropout_exe(mt, x, p, mode)
    y = exe.forward(is_train=is_train)[0].asnumpy()
    kept = y != 0
    # the same f32 division the op makes
    np.testing.assert_array_equal(
        y[kept], (torch.from_numpy(x) / keep).numpy()[kept])
    if is_train:
        exe.backward(mt.nd.array(dy, ctx="cpu"))
        np.testing.assert_array_equal(
            exe.grad_dict["data"].asnumpy(),
            np.where(kept, (torch.from_numpy(dy) / keep).numpy(), 0))
    share = kept.mean()
    sigma = np.sqrt(keep * p / kept.size)
    assert abs(share - keep) < 5 * sigma, share


def test_dropout_draws_repeat_with_the_seed_and_differ_without():
    x = _x((32, 32))
    exe = _dropout_exe(mt, x, 0.5)
    mt.random.seed(9)
    a = exe.forward(is_train=True)[0].asnumpy()
    b = exe.forward(is_train=True)[0].asnumpy()
    mt.random.seed(9)
    again = exe.forward(is_train=True)[0].asnumpy()
    mt.random.seed(10)
    other = exe.forward(is_train=True)[0].asnumpy()
    np.testing.assert_array_equal(a, again)
    assert not np.array_equal(a, b) and not np.array_equal(a, other)


def test_dropout_reads_the_training_flag_of_autograd():
    """The reference's training-flag test: Dropout in ``record`` acts,
    ``record(train_mode=False)`` / outside it is the identity."""
    x = mt.nd.array(np.ones((50, 40), np.float32), ctx="cpu")
    with mt.autograd.record():
        y = mt.nd.Dropout(x, p=0.5)
    with mt.autograd.record(train_mode=False):
        z = mt.nd.Dropout(x, p=0.5)
    assert set(np.unique(y.asnumpy())) == {0.0, 2.0}
    np.testing.assert_array_equal(z.asnumpy(), x.asnumpy())


def test_a_draw_without_the_generator_raises():
    attrs = treg.get_op("Dropout").parse_attrs({"p": 0.5})
    x = torch.ones(3, 4)
    with pytest.raises(MXNetError, match="generator"):
        treg.get_op("Dropout").impl(attrs, (x,), (), treg.OpContext(True))


def _lstm_blob(rng, layers, i, h):
    return (rng.uniform(-0.4, 0.4, trnn.rnn_param_size(layers, i, h, "lstm"))
            .astype(np.float32))


def _layer_blob(blob, layer, layers, i, h):
    """Layer ``layer``'s [wi, wh, bi, bh] of a packed ``layers``-layer LSTM
    blob, as a 1-layer blob."""
    parts = trnn._unpack_params(torch.from_numpy(blob), layers, i, h,
                                "lstm", 1)[layer][0]
    return np.concatenate([p.reshape(-1).numpy() for p in parts])


def test_rnn_dropout_between_layers_matches_jax_with_the_same_mask():
    t, n, i, h, p = 5, 3, 4, 6, 0.5
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (t, n, i)).astype(np.float32)
    blob = _lstm_blob(rng, 2, i, h)
    h0 = rng.uniform(-0.5, 0.5, (2, n, h)).astype(np.float32)
    c0 = rng.uniform(-0.5, 0.5, (2, n, h)).astype(np.float32)
    op = treg.get_op("RNN")
    attrs = op.parse_attrs({"state_size": h, "num_layers": 2,
                            "mode": "lstm", "p": p})
    (got,), _ = op.impl(
        attrs, tuple(torch.from_numpy(a) for a in (x, blob, h0, c0)), (),
        treg.OpContext(True, torch.device("cpu"),
                       rng=torch.Generator().manual_seed(21)))
    mask = trandom.keep_mask((t, n, h), 1 - p,
                             torch.Generator().manual_seed(21),
                             torch.device("cpu"), torch.float32).numpy()

    def jax_layer(data, layer, inp):
        return mx.nd.RNN(
            mx.nd.array(data), mx.nd.array(_layer_blob(blob, layer, 2, i, h)
                                           if layer == 0 else
                                           _layer_blob(blob, 1, 2, i, h)),
            mx.nd.array(h0[layer:layer + 1]),
            mx.nd.array(c0[layer:layer + 1]), state_size=h, num_layers=1,
            mode="lstm").asnumpy()

    y0 = jax_layer(x, 0, i)
    want = jax_layer(y0 * mask / (1 - p), 1, h)
    np.testing.assert_allclose(got.numpy(), want, **RNN_TOL)
    assert 0 < mask.sum() < mask.size
    (plain,), _ = op.impl(
        dict(attrs, p=0.0),
        tuple(torch.from_numpy(a) for a in (x, blob, h0, c0)), (),
        treg.OpContext(True, torch.device("cpu")))
    assert not np.allclose(got.numpy(), plain.numpy())


def _cell_stack(pkg, kind):
    if kind == "dropout":
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(5, prefix="l0_"))
        stack.add(pkg.rnn.DropoutCell(0.5, prefix="d0_"))
        stack.add(pkg.rnn.LSTMCell(5, prefix="l1_"))
        return stack
    return pkg.rnn.ZoneoutCell(pkg.rnn.LSTMCell(5, prefix="l0_"),
                               zoneout_outputs=0.0, zoneout_states=0.5)


def _cell_eval(pkg, kind, values=None):
    cell = _cell_stack(pkg, kind)
    out, _ = cell.unroll(3, pkg.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    exe = out.simple_bind(pkg.cpu(), data=(2, 3, 4))
    rng = np.random.RandomState(8)
    if values is None:
        values = {n: rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
                  for n, a in exe.arg_dict.items()}
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    return exe.forward(is_train=False)[0].asnumpy(), values


@pytest.mark.parametrize("kind", ["dropout", "zoneout"])
def test_dropout_and_zoneout_cells_in_eval_match_jax(kind):
    want, values = _cell_eval(mx, kind)
    got, _ = _cell_eval(mt, kind, values)
    np.testing.assert_allclose(got, want, **CELL_TOL)


def test_zoneout_outputs_are_the_new_or_the_old_value():
    cell = mt.rnn.ZoneoutCell(mt.rnn.LSTMCell(6, prefix="l_"),
                              zoneout_outputs=0.5, zoneout_states=0.5)
    outs, _ = cell.unroll(3, mt.sym.Variable("data"), layout="NTC")
    # the step's where(mask, new output, previous output): its input 1
    fresh = mt.sym.Symbol([outs[2]._entries[0][0].inputs[1]])
    net = mt.sym.Group([outs[1], outs[2], fresh])
    exe = net.simple_bind("cpu", data=(4, 3, 5))
    rng = np.random.RandomState(2)
    for n, a in exe.arg_dict.items():
        a[:] = rng.uniform(-1, 1, a.shape).astype(np.float32)
    mt.random.seed(4)
    old, out, fresh = (o.asnumpy() for o in exe.forward(is_train=True))
    took_new, took_old = out == fresh, out == old
    assert np.all(took_new | took_old)
    assert took_new.any() and (took_old & ~took_new).any()


def test_ones_like_and_where_match_jax():
    x = _x((4, 5))
    y = _x((4, 5), seed=1)
    cond = (np.random.RandomState(2).rand(4, 5) > 0.5).astype(np.float32)
    rows = np.array([1, 0, 0, 1], np.float32)
    for c in (cond, rows):
        got = mt.nd.where(*(mt.nd.array(a, ctx="cpu") for a in (c, x, y)))
        want = mx.nd.where(*(mx.nd.array(a) for a in (c, x, y)))
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(
        mt.nd.ones_like(mt.nd.array(x, ctx="cpu")).asnumpy(),
        mx.nd.ones_like(mx.nd.array(x)).asnumpy())


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 33 + 5])
def test_random_seed_leaves_numpy_as_the_jax_package_does(seed):
    mx.random.seed(seed)
    want = np.random.rand(5)
    mt.random.seed(seed)
    got = np.random.rand(5)
    np.testing.assert_array_equal(got, want)
    a = torch.rand(4, generator=mt.random.generator("cpu"))
    mt.random.seed(seed)
    b = torch.rand(4, generator=mt.random.generator("cpu"))
    assert torch.equal(a, b)
