"""The image-classification zoo of the port against the JAX package's, on
the CPU.

- Every builder key of the JAX package's ``models`` (``ssd-vgg16`` with
  its label):
  the same arguments, aux states and inferred shapes at the published
  input, in fresh name scopes (the unnamed layers take their auto-names).
- alexnet (Dropout at p = 0 through the symbol's JSON), a narrow ResNeXt
  stage (two units of ``resnext._unit``, 4 groups) and Inception-BN at the
  smallest input each accepts: one executor forward and backward, both
  packages in f64 on the same weights carried across as numpy arrays,
  within 1e-9 of each array's largest entry.
- ``Module.fit`` of Inception-BN and of alexnet (p = 0, JSON route), 2
  batches of 4, against the JAX package's ``Module.fit`` in f32, at the
  gates the test states (the chip phase's kind: updates and aux changes
  after batch 1, the cross-entropy after each batch).
- Reference symbol JSON naming the new ops loads through
  ``interop.load_symbol_json``.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models import _BUILDERS as JAX_BUILDERS
from mxnet_tpu_torch import interop
from mxnet_tpu_torch.tools.image_zoo import dead_shifts, \
    without_dropout, wgrad_shapes
from mxnet_tpu_torch.tools.resnet import change_err, wgrad_convs


# builder key -> (kwargs, input shapes) at the published input; the rest
# take 3 x 224 x 224 images
INPUTS = {"mlp": ({}, {"data": (1, 784)}),
          "lenet": ({}, {"data": (1, 1, 28, 28)}),
          "inception-v3": ({}, {"data": (1, 3, 299, 299)}),
          "inception-resnet-v2": ({}, {"data": (1, 3, 299, 299)}),
          "lstm-lm": ({}, {"data": (2, 35), "softmax_label": (2, 35)}),
          "transformer-lm": ({"seq_len": 16, "num_layers": 1},
                             {"data": (2, 16), "softmax_label": (2, 16)}),
          "ssd-vgg16": ({}, {"data": (1, 3, 300, 300), "label": (1, 8, 5)})}


def _jax_without_dropout(sym):
    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = "0.0"
    return mx.sym.load_json(json.dumps(graph))


def _both(name, **kwargs):
    """The model ``name`` built by each package in a fresh name scope."""
    with mx.name.NameManager():
        want = mx.models.get_symbol(name, **kwargs)
    with mt.name.NameManager():
        got = mt.models.get_symbol(name, **kwargs)
    return got, want


@pytest.mark.parametrize("name", sorted(JAX_BUILDERS))
def test_builder_matches_jax(name):
    kwargs, shapes = INPUTS.get(name, ({}, {"data": (1, 3, 224, 224)}))
    got, want = _both(name, **kwargs)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    assert got.list_outputs() == want.list_outputs()
    g, w = got.infer_shape(**shapes), want.infer_shape(**shapes)
    for gs, ws in zip(g, w):
        assert [tuple(s) for s in gs] == [tuple(s) for s in ws]


def test_only_ssd_is_missing_from_the_zoo():
    """Nothing is missing any more: the port has every builder key of the
    JAX package's zoo (ssd-vgg16 the last), and no other."""
    assert set(JAX_BUILDERS) == set(mt.models._BUILDERS)
    assert mt.models.get_symbol("ssd-vgg16").list_outputs() == [
        "cls_prob_output", "loc_loss_output", "cls_target_output"]
    with pytest.raises(ValueError, match="unknown model"):
        mt.models.get_symbol("ssd-vgg19")


def _resnext_stage(pkg):
    """Two ResNeXt units of 4 groups (``resnext._unit``), the first with a
    projection shortcut and stride 2, under a SoftmaxOutput head."""
    mod = pkg.models.resnext
    data = pkg.sym.Variable("data")
    body = mod._unit(data, 64, (2, 2), False, "stage1_unit1", 4, 0.9, 256)
    body = mod._unit(body, 64, (1, 1), True, "stage1_unit2", 4, 0.9, 256)
    pool = pkg.sym.Pooling(body, global_pool=True, kernel=(1, 1),
                           pool_type="avg")
    fc = pkg.sym.FullyConnected(pkg.sym.Flatten(pool), num_hidden=5,
                                name="fc")
    return pkg.sym.SoftmaxOutput(fc, name="softmax")


# model -> (both packages' symbols, data shape): the smallest input each
# accepts (alexnet: 67, the 11x11/4 stem and three 3x3/2 pools; Inception-BN:
# 32, five stride-2 stages)
def _exec_models():
    return {
        "alexnet": (lambda pkg, dropless: dropless(pkg.models.get_symbol(
            "alexnet", num_classes=10)), (2, 3, 67, 67)),
        "resnext_stage": (lambda pkg, _d: _resnext_stage(pkg),
                          (2, 16, 8, 8)),
        "inception-bn": (lambda pkg, _d: pkg.models.get_symbol(
            "inception-bn", num_classes=10), (2, 3, 32, 32))}


def _bind_f64(pkg, sym, shapes):
    """``sym`` bound on the CPU with every argument and aux state f64."""
    f64 = {n: np.float64 for n in sym.list_arguments()}
    if pkg is mx:
        return sym.simple_bind(mx.cpu(), type_dict=f64, **shapes)
    exe = sym.simple_bind("cpu", type_dict=f64, **shapes)
    for arr in exe.aux_dict.values():
        arr._data = arr._data.double()
    return exe


def _run_f64(pkg, sym, shapes, values, aux_values):
    exe = _bind_f64(pkg, sym, shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    for n, v in aux_values.items():
        exe.aux_dict[n][:] = v
    exe.forward(is_train=True)
    exe.backward()
    return exe.outputs[0].asnumpy(), {
        n: g.asnumpy() for n, g in exe.grad_dict.items()
        if g is not None and n not in shapes}


@pytest.mark.parametrize("name", ["alexnet", "resnext_stage",
                                  "inception-bn"])
def test_executor_forward_backward_matches_jax(name):
    """Both packages in f64 (the JAX package under ``jax.enable_x64``), so
    the comparison sees the functions and not f32 rounding, which batch
    norm at 1 x 1 over a batch of 2 amplifies past any fixed tolerance:
    the output and every gradient within 1e-9 of its largest entry; the
    biases ahead of batch norms, zero in exact arithmetic, within 1e-9 of
    the largest gradient of the network on both sides."""
    import jax

    build, shape = _exec_models()[name]
    with mx.name.NameManager():
        jsym = build(mx, _jax_without_dropout)
    with mt.name.NameManager():
        tsym = build(mt, without_dropout)
    assert tsym.list_arguments() == jsym.list_arguments()
    shapes = {"data": shape, "softmax_label": (shape[0],)}
    arg_shapes, _, aux_shapes = tsym.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    values = {}
    for n, s in zip(tsym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            values[n] = rng.randint(0, 5, s).astype(np.float64)
        elif n.endswith("gamma"):
            values[n] = rng.uniform(0.5, 1.5, s)
        else:
            values[n] = rng.randn(*s) / np.sqrt(
                int(np.prod(s[1:])) if len(s) > 1 else 1)
    aux_values = {n: np.full(s, 1.0 if n.endswith("var") else 0.0)
                  for n, s in zip(tsym.list_auxiliary_states(), aux_shapes)}
    with jax.enable_x64(True):
        want_out, want = _run_f64(mx, jsym, shapes, values, aux_values)
    got_out, got = _run_f64(mt, tsym, shapes, values, aux_values)
    assert got_out.dtype == want_out.dtype == np.float64
    assert np.abs(got_out - want_out).max() <= 1e-9 * np.abs(want_out).max()
    assert set(got) == set(want)
    zero = set(dead_shifts(tsym))
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        if n in zero:
            assert max(np.abs(w).max(), np.abs(got[n]).max()) <= 1e-9 * top
            continue
        err = float(np.abs(got[n] - w).max())
        assert err <= 1e-9 * float(np.abs(w).max()), (n, err)


def test_wgrad_routing_of_the_zoo():
    """Inception-BN routes its 31 3x3 convolutions to conv_wgrad; ResNeXt's
    grouped 3x3 stay on autograd (none routed); the stems of 3 channels at
    299 are routed with stride 2 and pad 0."""
    sym = mt.models.get_symbol("inception-bn", num_classes=1000)
    assert wgrad_convs(sym) == 31
    shapes = wgrad_shapes(sym, (3, 224, 224), 32)
    assert sum(shapes.values()) == 31 and len(shapes) == 21
    assert wgrad_convs(mt.models.get_symbol("resnext-50")) == 0
    v3 = wgrad_shapes(mt.models.get_symbol("inception-v3"),
                      (3, 299, 299), 32)
    assert v3[(32, 299, 299, 3, 32, 2, 0)] == 1
    assert v3[(32, 147, 147, 32, 64, 1, 1)] == 1


# model -> (image, classes) of the fit comparison: 4 images a batch, so
# Inception-BN's last batch norms see 16 values a channel
FIT_MODELS = {"inception-bn": ((3, 64, 64), 10),
              "alexnet": ((3, 67, 67), 10)}


def _fit(pkg, name, dropless):
    """2 batches of 4 through ``Module.fit``; the parameters and aux
    states before and after each batch, and the metrics."""
    shape, classes = FIT_MODELS[name]
    with pkg.name.NameManager():
        sym = dropless(pkg.models.get_symbol(name, num_classes=classes))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (8,) + shape).astype(np.float32)
    y = rng.randint(0, classes, 8).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=4)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    init = pkg.initializer.Xavier(factor_type="in", magnitude=2)
    mod.init_params(init)

    def state():
        return [{k: v.asnumpy().copy() for k, v in d.items()}
                for d in mod.get_params()]

    states, metrics = [state()], []

    def record(param):
        states.append(state())
        metrics.append([float(v) for _, v in
                        param.eval_metric.get_name_value()])

    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9),
                              ("wd", 1e-4)),
            initializer=init, eval_metric=["acc", "ce"],
            batch_end_callback=record)
    return states, np.array(metrics), sym


@pytest.mark.parametrize("name", sorted(FIT_MODELS))
def test_module_fit_matches_jax(name):
    """The chip phase's gates at this size. After batch 1 each update
    within 0.1 (L2) of the reference's: the JAX package's own f32
    gradients lie a median 6e-3 from its f64 ones here (the port's 3e-5),
    which puts the worst update 4.5e-2 off; each aux state's change within
    1e-3; the metrics within 1e-5. After batch 2 the cross-entropy within
    2e-2: at lr 0.05 a change of the initial weights by 1e-6 moves the
    port's own batch-2 loss by 1.5e-2. The convolution biases ahead of
    batch norms (zero gradient in exact arithmetic) within 1e-6 of the
    reference's change, absolutely."""
    got, gm, sym = _fit(mt, name, without_dropout)
    want, wm, _ = _fit(mx, name, _jax_without_dropout)
    (g0, gx0), (g1, gx1) = got[0], got[1]
    (w0, wx0), (w1, wx1) = want[0], want[1]
    assert set(g1) == set(w1) and set(gx1) == set(wx1)
    noise = set(dead_shifts(sym))
    assert len(noise) == (69 if name == "inception-bn" else 0)
    for k in w1:
        np.testing.assert_array_equal(g0[k], w0[k])
        if k in noise:
            diff = np.abs((got[2][0][k] - g0[k]) - (want[2][0][k] - w0[k]))
            assert diff.max() <= 1e-6, (k, diff.max())
            continue
        err = change_err(g1[k] - g0[k], w1[k] - w0[k])
        assert err <= 0.1, (k, err)
    for k in wx1:
        err = change_err(gx1[k] - gx0[k], wx1[k] - wx0[k])
        assert err <= 1e-3, (k, err)
    assert gm.shape == (2, 2)
    np.testing.assert_allclose(gm[0], wm[0], rtol=1e-5)
    assert abs(gm[1, 1] - wm[1, 1]) <= 2e-2 * wm[1, 1]


def test_without_dropout_sets_every_p_to_zero():
    sym = mt.models.get_symbol("vgg16", num_classes=10)
    ps = [n.attrs["p"] for n in sym._nodes()
          if not n.is_var and n.op.name == "Dropout"]
    assert ps == [0.5, 0.5]
    dropless = without_dropout(sym)
    assert [n.attrs["p"] for n in dropless._nodes()
            if not n.is_var and n.op.name == "Dropout"] == [0.0, 0.0]
    assert dropless.list_arguments() == sym.list_arguments()


def test_reference_json_of_the_new_ops_loads():
    """The JAX package's reference-schema JSON of a graph built from the
    new ops loads through the port's ``interop.load_symbol_json`` with the
    same arguments, aux states and shapes; so does the port's own."""
    def build(pkg):
        data = pkg.sym.Variable("data")
        x = pkg.sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2),
                                  adj=(1, 1), num_filter=4, name="de")
        x = pkg.sym.LeakyReLU(x, act_type="prelu", name="pr")
        x = pkg.sym.LRN(x, nsize=3, name="lrn")
        x = pkg.sym.InstanceNorm(x, name="inorm")
        x = pkg.sym.Pad(x, mode="reflect", pad_width=(0, 0, 0, 0, 1, 1, 2, 2),
                        name="pad")
        x = pkg.sym.Cast(x, dtype="float32", name="cast")
        x = pkg.sym.transpose(pkg.sym.Flatten(x), axes=(1, 0), name="tr")
        x = pkg.sym.topk(pkg.sym.transpose(x), k=2, ret_typ="value",
                         name="top")
        return pkg.sym.LinearRegressionOutput(x, name="reg")

    with mx.name.NameManager():
        jsym = build(mx)
    with mt.name.NameManager():
        tsym = build(mt)
    shape = {"data": (2, 3, 5, 5)}
    for text in (jsym.tojson(format="reference"),
                 tsym.tojson(format="reference")):
        loaded = interop.load_symbol_json(text)
        assert loaded.list_arguments() == jsym.list_arguments()
        assert loaded.list_auxiliary_states() == \
            jsym.list_auxiliary_states()
        assert [tuple(s) for s in loaded.infer_shape(**shape)[1]] == \
            [tuple(s) for s in jsym.infer_shape(**shape)[1]]
