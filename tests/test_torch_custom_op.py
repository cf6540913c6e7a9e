"""mxnet_tpu_torch's Custom operators against the JAX package's, on the CPU.

The same user op classes (numpy-style, written once over both packages'
``CustomOp`` surface: ``asnumpy`` in, ``assign`` out) are registered in
both packages, and the same numpy inputs go through both:

- the counterparts of ``tests/test_custom_op.py``: imperative forward and
  autograd, symbolic forward / backward, an unregistered op_type raising,
  shape inference through a symbol;
- a ``need_top_grad=False`` softmax head against ``SoftmaxOutput`` (the
  head gradient ignored), an op with an aux state, ``grad_req="add"`` and
  ``CustomOp.assign``'s reqs, the legacy ``PythonOp``, the operator created
  once across ``Module.fit`` batches, a label shape inferred through the
  op's ``infer_params``, and the backward keeping only the arrays that the
  prop's ``declare_backward_dependency`` names;
- the slice as a whole: the tiny LSTM LM (vocab 50, embed = hidden = 16, 2
  layers, seq 5, batch 4) through ``Module.fit`` for 2 batches with the
  ``rtc_softmax`` head (its torch twins on the CPU), against the JAX
  package with a numpy Custom head of the same maths and with its
  ``SoftmaxOutput`` head.

Values and gradients agree within rtol 1e-5 / atol 1e-6, the tolerance
``tests/test_torch_rnn.py`` holds the LSTM LM's ``Module.fit`` to (f32 both
sides; sums in other orders).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import rtc_softmax as rs

TOL = {"rtol": 1e-5, "atol": 1e-6}
CTX = {mt: "cpu", mx: None}
LM = {"vocab": 50, "embed": 16, "hidden": 16, "layers": 2, "seq": 5,
      "batch": 4, "batches": 2, "lr": 0.5}


def _register(pkg):
    """Register the test ops in ``pkg``; returns the creation counter."""
    op_mod = pkg.operator
    created = {"n": 0, "sigmoid_in": None}

    class Square(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() ** 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2.0 * in_data[0].asnumpy() * out_grad[0].asnumpy())

    @op_mod.register("tt_square")
    class SquareProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Square()

    class NumpySoftmax(op_mod.CustomOp):
        """examples/numpy-ops/custom_softmax.py's head; ``scale`` 1 is
        SoftmaxOutput's normalization null, 1 / batch the example's."""

        def __init__(self, batch_norm):
            self.batch_norm = batch_norm

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            prob = out_data[0].asnumpy().copy()
            label = in_data[1].asnumpy().astype(int)
            prob[np.arange(label.size), label] -= 1.0
            scale = 1.0 / label.size if self.batch_norm else 1.0
            self.assign(in_grad[0], req[0], prob * scale)
            self.assign(in_grad[1], req[1],
                        np.zeros_like(in_data[1].asnumpy()))

    def softmax_prop(batch_norm):
        class SoftmaxProp(op_mod.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=False)

            def list_arguments(self):
                return ["data", "label"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

            def create_operator(self, ctx, shapes, dtypes):
                created["n"] += 1
                return NumpySoftmax(batch_norm)

        return SoftmaxProp

    op_mod.register("tt_softmax")(softmax_prop(False))
    op_mod.register("tt_softmax_batch")(softmax_prop(True))

    class Sigmoid(op_mod.CustomOp):
        """Its backward reads the output and the head gradient only."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            created["sigmoid_in"] = in_data[0]
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        y * (1.0 - y) * out_grad[0].asnumpy())

    @op_mod.register("tt_sigmoid")
    class SigmoidProp(op_mod.CustomOpProp):
        def declare_backward_dependency(self, out_grad, in_data, out_data):
            return [out_grad[0], out_data[0]]

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Running(op_mod.CustomOp):
        """out = x - r', where the aux state r' = (r + mean(x)) / 2."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            r = 0.5 * (aux[0].asnumpy() + x.mean())
            aux[0][:] = r
            self.assign(out_data[0], req[0], x - r)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0].asnumpy())

    @op_mod.register("tt_running")
    class RunningProp(op_mod.CustomOpProp):
        def list_auxiliary_states(self):
            return ["running"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def create_operator(self, ctx, shapes, dtypes):
            return Running()

    class Cube(op_mod.PythonOp):
        def forward_np(self, in_data, out_data):
            out_data[0][:] = in_data[0] ** 3

        def backward_np(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 3.0 * in_data[0] ** 2 * out_grad[0]

    @op_mod.register("tt_cube")
    class CubeProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Cube()

    return created


CREATED = {mt: _register(mt), mx: _register(mx)}


def _nd(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=CTX[pkg])


# --- the counterparts of tests/test_custom_op.py --------------------------------
@pytest.mark.parametrize("pkg", [mt, mx], ids=["torch", "jax"])
def test_custom_imperative_forward(pkg):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    out = pkg.nd.Custom(_nd(pkg, x), op_type="tt_square").asnumpy()
    np.testing.assert_allclose(out, x ** 2, **TOL)


def _imperative_grad(pkg, x_np):
    x = _nd(pkg, x_np)
    x.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.Custom(x, op_type="tt_square")
        loss = y.sum()
    loss.backward()
    return loss.asnumpy(), x.grad.asnumpy()


def test_custom_imperative_autograd():
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    got, want = _imperative_grad(mt, x), _imperative_grad(mx, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[1], 2 * x, **TOL)


def _symbolic(pkg, xval, grad_req="write", rounds=1, og=1.0):
    data = pkg.sym.Variable("data")
    y = pkg.sym.Custom(data=data, op_type="tt_square", name="sq")
    exe = y.simple_bind(pkg.cpu(), data=xval.shape, grad_req=grad_req)
    exe.arg_dict["data"][:] = xval
    for _ in range(rounds):
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=_nd(pkg, np.full(xval.shape, og)))
    return out, exe.grad_dict["data"].asnumpy()


def test_custom_symbolic_forward_backward():
    xval = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    (out, grad), (w_out, w_grad) = _symbolic(mt, xval), _symbolic(mx, xval)
    np.testing.assert_allclose(out, w_out, **TOL)
    np.testing.assert_allclose(grad, w_grad, **TOL)
    np.testing.assert_allclose(grad, 2 * xval, **TOL)


def test_custom_unregistered_raises():
    with pytest.raises(MXNetError, match="not registered"):
        mt.nd.Custom(mt.nd.ones((2, 2), ctx="cpu"),
                     op_type="definitely_not_registered")


def test_custom_shape_inference_through_symbol():
    shapes = []
    for pkg in (mt, mx):
        y = pkg.sym.Custom(data=pkg.sym.Variable("data"), op_type="tt_square")
        shapes.append(y.infer_shape(data=(7, 2)))
    assert [tuple(s) for s in shapes[0][1]] == [(7, 2)]
    assert [tuple(s) for s in shapes[0][1]] == [tuple(s)
                                                 for s in shapes[1][1]]


# --- beyond the reference's tests -----------------------------------------------
def _head(pkg, op_type, logits, label, og):
    data = pkg.sym.Variable("data")
    lab = pkg.sym.Variable("softmax_label")
    if op_type is None:
        head = pkg.sym.SoftmaxOutput(data=data, label=lab, name="softmax")
    else:
        head = pkg.sym.Custom(data=data, label=lab, op_type=op_type,
                              name="softmax")
    exe = head.simple_bind(pkg.cpu(), data=logits.shape,
                           softmax_label=label.shape,
                           grad_req={"data": "write",
                                     "softmax_label": "null"})
    exe.arg_dict["data"][:] = logits
    exe.arg_dict["softmax_label"][:] = label
    prob = exe.forward(is_train=True)[0].asnumpy()
    exe.backward(out_grads=_nd(pkg, np.full(logits.shape, og)))
    return prob, exe.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("og", [1.0, 2.5])
def test_need_top_grad_false_head_equals_softmax_output(og):
    """The head gradient is ignored: at any ``out_grads`` the Custom head's
    data gradient is SoftmaxOutput's p - onehot(label)."""
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 9).astype(np.float32)
    label = rng.randint(0, 9, 6).astype(np.float32)
    got = _head(mt, "tt_softmax", logits, label, og)
    for want in (_head(mt, None, logits, label, og),
                 _head(mx, None, logits, label, og),
                 _head(mx, "tt_softmax", logits, label, og)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


def _sigmoid_grad(pkg, x_np, og_np):
    x = _nd(pkg, x_np)
    x.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.Custom(x, op_type="tt_sigmoid")
    y.backward(_nd(pkg, og_np))
    return y.asnumpy(), x.grad.asnumpy()


def test_backward_gets_only_the_declared_dependencies():
    """The prop declares the output and the head gradient: the port keeps
    no copy of the input for the backward, which sees the input's shape
    with no data, as the reference's custom.cc keeps only what
    ``declare_backward_dependency`` names. Values as the JAX package's."""
    rng = np.random.RandomState(8)
    x, og = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3)
    got = _sigmoid_grad(mt, x, og)
    seen = CREATED[mt]["sigmoid_in"]
    assert seen.shape == x.shape and seen.context.type == "meta"
    for g, w in zip(got, _sigmoid_grad(mx, x, og)):
        np.testing.assert_allclose(g, w, **TOL)


def test_rtc_softmax_head_keeps_probabilities_and_label_not_logits():
    """``rtc_softmax`` declares its output and the label: autograd saves
    those two tensors and not the logits (at the LSTM LM's width, 179 MB
    that need not live until the backward). Its data gradient is the JAX
    package's SoftmaxOutput gradient."""
    rng = np.random.RandomState(9)
    logits_np = rng.randn(6, 9).astype(np.float32)
    label_np = rng.randint(0, 9, 6).astype(np.float32)
    logits, label = _nd(mt, logits_np), _nd(mt, label_np)
    logits.attach_grad()
    saved = []

    def pack(t):
        saved.append(t.data_ptr())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with mt.autograd.record():
            prob = mt.nd.Custom(logits, label, op_type="rtc_softmax")
    prob.backward()
    assert sorted(saved) == sorted([prob._data.data_ptr(),
                                    label._data.data_ptr()])
    want = _head(mx, None, logits_np, label_np, 1.0)
    np.testing.assert_allclose(prob.asnumpy(), want[0], **TOL)
    np.testing.assert_allclose(logits.grad.asnumpy(), want[1], **TOL)


def _running(pkg, xs):
    """Bound with explicit arrays: the JAX package cannot infer a Custom
    op's aux shapes (the port's simple_bind can: see the test below).
    Returns, per input, the output and the aux state after the training
    forward, then the aux state and the data gradient after the backward."""
    y = pkg.sym.Custom(data=pkg.sym.Variable("data"), op_type="tt_running",
                       name="run")
    shape = xs[0].shape
    exe = y.bind(pkg.cpu(), args={"data": _nd(pkg, np.zeros(shape))},
                 args_grad={"data": _nd(pkg, np.zeros(shape))},
                 aux_states={"run_running": _nd(pkg, np.zeros(1))})
    runs = []
    for x in xs:
        exe.arg_dict["data"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        aux = exe.aux_dict["run_running"].asnumpy()
        exe.backward(out_grads=_nd(pkg, np.full(shape, 0.5)))
        runs.append((out, aux, exe.aux_dict["run_running"].asnumpy(),
                     exe.grad_dict["data"].asnumpy()))
    return y.list_auxiliary_states(), runs


def test_custom_op_with_an_aux_state():
    """Outputs, aux updates and gradients as the JAX package's, over two
    training forwards. The port's backward leaves the aux state as the
    forward left it, as the reference MXNet's does; the JAX package's
    ``Executor.backward`` runs the forward again and applies the aux
    update a second time (ROADMAP.md queue 3), so the second forward starts
    from other aux values there and only the first is compared."""
    rng = np.random.RandomState(5)
    xs = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]
    (names, got), (w_names, want) = _running(mt, xs), _running(mx, xs)
    assert names == w_names == ["run_running"]
    out, aux, aux_after, grad = got[0]
    w_out, w_aux, w_aux_after, w_grad = want[0]
    np.testing.assert_allclose(out, w_out, **TOL)
    np.testing.assert_allclose(aux, w_aux, **TOL)
    np.testing.assert_allclose(grad, w_grad, **TOL)
    np.testing.assert_allclose(aux, [0.5 * xs[0].mean()], **TOL)
    np.testing.assert_allclose(aux_after, aux)
    np.testing.assert_allclose(w_aux_after, [0.75 * xs[0].mean()], **TOL)
    # the second forward continues from the port's own aux state
    np.testing.assert_allclose(got[1][1], [0.5 * (aux[0] + xs[1].mean())],
                               **TOL)
    np.testing.assert_allclose(got[1][0], xs[1] - got[1][1], **TOL)
    exe = mt.sym.Custom(data=mt.sym.Variable("data"), op_type="tt_running",
                        name="run").simple_bind("cpu", data=(4, 3))
    assert exe.aux_dict["run_running"].shape == (1,)


def test_grad_req_add_accumulates_like_jax():
    xval = np.random.RandomState(6).randn(3, 2).astype(np.float32)
    got = _symbolic(mt, xval, grad_req="add", rounds=2, og=1.5)
    want = _symbolic(mx, xval, grad_req="add", rounds=2, og=1.5)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[1], 2 * 2 * xval * 1.5, rtol=1e-5)


@pytest.mark.parametrize("req,want", [
    ("null", [1.0, 1.0]), (0, [1.0, 1.0]), ("write", [2.0, 3.0]),
    (1, [2.0, 3.0]), ("inplace", [2.0, 3.0]), (2, [2.0, 3.0]),
    ("add", [3.0, 4.0]), (3, [3.0, 4.0])])
def test_assign_honours_every_req(req, want):
    dst = _nd(mt, [1.0, 1.0])
    for src in (np.array([2.0, 3.0]), _nd(mt, [2.0, 3.0]),
                _nd(mt, [2.0, 3.0])._data):
        dst[:] = np.ones(2, np.float32)
        mt.operator.CustomOp.assign(dst, req, src)
        np.testing.assert_allclose(dst.asnumpy(), want)
    with pytest.raises(MXNetError, match="unknown req"):
        mt.operator.CustomOp.assign(dst, "sometimes", 1.0)


def _cube(pkg, xval):
    y = pkg.sym.Custom(data=pkg.sym.Variable("data"), op_type="tt_cube")
    exe = y.simple_bind(pkg.cpu(), data=xval.shape)
    exe.arg_dict["data"][:] = xval
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward(out_grads=_nd(pkg, np.full(xval.shape, 0.5)))
    return out, exe.grad_dict["data"].asnumpy()


def test_python_op_matches_jax():
    xval = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    got, want = _cube(mt, xval), _cube(mx, xval)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[1], 1.5 * xval ** 2, rtol=1e-5)


def _mlp_fit(pkg):
    rng = np.random.RandomState(8)
    x = rng.randn(12, 5).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=4)
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    net = pkg.sym.Custom(data=h, label=pkg.sym.Variable("softmax_label"),
                         op_type="tt_softmax_batch", name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(9)
    init = pkg.initializer.Xavier()
    mod.init_params(init)
    states = []
    CREATED[pkg]["n"] = 0
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.2), ("momentum", 0.9)),
            initializer=init, eval_metric="acc",
            batch_end_callback=lambda p: states.append(
                {k: v.asnumpy().copy()
                 for k, v in mod.get_params()[0].items()}))
    return states, CREATED[pkg]["n"]


def test_operator_created_once_across_module_fit_batches():
    """The numpy-ops example's head (÷ batch) in an MLP: 3 batches of
    ``Module.fit`` create the operator once, and train as the JAX
    package does."""
    (got, n_created), (want, _) = _mlp_fit(mt), _mlp_fit(mx)
    assert n_created == 1
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)


def test_label_shape_is_inferred_through_infer_params():
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=6, name="fc")
    net = mt.sym.Custom(data=h, label=mt.sym.Variable("softmax_label"),
                        op_type="tt_softmax", name="softmax")
    args, outs, _ = net.infer_shape(data=(4, 10))
    assert dict(zip(net.list_arguments(), args)) == {
        "data": (4, 10), "fc_weight": (6, 10), "fc_bias": (6,),
        "softmax_label": (4,)}
    assert outs == [(4, 6)]
    exe = net.simple_bind("cpu", data=(4, 10))
    assert exe.arg_dict["softmax_label"].shape == (4,)


def test_shape_inference_runs_no_user_code():
    """On meta tensors the outputs come from the prop: no operator is
    created."""
    CREATED[mt]["n"] = 0
    net = mt.sym.Custom(data=mt.sym.Variable("data"),
                        label=mt.sym.Variable("label"),
                        op_type="tt_softmax")
    assert net.infer_shape(data=(3, 5))[1] == [(3, 5)]
    assert CREATED[mt]["n"] == 0


# --- the slice as a whole -------------------------------------------------------
def _lstm_symbol(pkg, head):
    sym = pkg.models.get_symbol(
        "lstm-lm", num_classes=LM["vocab"], seq_len=LM["seq"],
        num_embed=LM["embed"], num_hidden=LM["hidden"],
        num_layers=LM["layers"], fused=True)
    if head == "SoftmaxOutput":
        return sym
    if head == "rtc_softmax":
        return rs.lstm_rtc_symbol(LM)
    pred = sym.get_internals()["pred_output"]
    label = pkg.sym.Reshape(data=pkg.sym.Variable("softmax_label"),
                            shape=(-1,))
    return pkg.sym.Custom(data=pred, label=label, op_type=head,
                          name="softmax")


def _fit_lstm(pkg, head):
    sym = _lstm_symbol(pkg, head)
    rng = np.random.RandomState(0)
    shape = (LM["batch"] * LM["batches"], LM["seq"])
    x = rng.randint(0, LM["vocab"], shape).astype(np.float32)
    y = rng.randint(0, LM["vocab"], shape).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=LM["batch"])
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    init = pkg.initializer.Xavier()
    mod.init_params(init)
    states, metrics = [], []

    def record(param):
        states.append({k: v.asnumpy().copy()
                       for k, v in mod.get_params()[0].items()})
        metrics.append(param.eval_metric.get_name_value()[0][1])

    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", LM["lr"]),),
            initializer=init, eval_metric=pkg.metric.Perplexity(None),
            batch_end_callback=record)
    return states, metrics


def test_lstm_lm_with_the_rtc_head_trains_like_jax():
    got_s, got_m = _fit_lstm(mt, "rtc_softmax")
    assert sorted(got_s[0]) == ["embed_weight", "lstm_parameters",
                                "pred_bias", "pred_weight"]
    for head in ("tt_softmax", "SoftmaxOutput"):
        want_s, want_m = _fit_lstm(mx, head)
        assert len(got_s) == len(want_s) == LM["batches"]
        for g, w in zip(got_s, want_s):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=(head, k),
                                           **TOL)
        np.testing.assert_allclose(got_m, want_m, **TOL)
