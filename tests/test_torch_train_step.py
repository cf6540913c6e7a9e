"""The whole training step of mxnet_tpu_torch against the JAX package, on
the CPU: ``Executor.make_train_step`` (with ``chain``), ``compute_dtype``
through ``simple_bind`` / ``bind`` / ``Module``, the optimizers'
``pure_rule`` and the fused ``Module.fit_step``.

On the CPU the step runs eagerly (the card captures it as a CUDA graph;
``chip_smoke.py`` holds the capture against the eager step there). The
same numpy weights and batches go into both packages.

Tolerances:
- f32 step against the reference's: rtol 2e-4 / atol 2e-5, the
  reference's own for its fused step (``tests/test_executor.py``); both
  sides run f32 on the CPU, summing in other orders. Adam: rtol 1e-3 /
  atol 1e-4, ``tests/test_torch_train.py``'s after several updates: its
  1/sqrt(var) turns last-bit differences in near-zero gradients into
  differences of the update's size.
- bf16 (``compute_dtype="bfloat16"``) against the reference's bf16: both
  round to bf16, but not at the same places (XLA fuses elementwise chains
  in f32, PyTorch rounds after each op), so the two differ by about as
  much as bf16 differs from f32. Measured over these seeds: the port's
  bf16 gradients and parameters lie from the reference's bf16 ones up to
  1.12x as far as the reference's bf16 ones lie from its f32 ones; the
  forward's outputs within one bf16 ulp (2^-7 relative), the losses of
  3 steps within two. Gates (``BF16_TOL``): outputs rtol 2^-7, losses
  rtol 2^-6, each gradient and the parameters after 3 steps within 1.5x
  the reference's own bf16-to-f32 distance.
- The fused path against the port's unfused one, and the device-lr
  updates against the scalar ones: bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import _launches
from mxnet_tpu_torch.ops.kernels import fused_update as fu

STEP_TOL = {"rtol": 2e-4, "atol": 2e-5}
ADAM_TOL = {"rtol": 1e-3, "atol": 1e-4}
BF16_TOL = {"out": 2.0 ** -7, "loss": 2.0 ** -6, "spread": 1.5}
LM = {"num_classes": 97, "num_layers": 2, "num_heads": 4, "model_dim": 64,
      "ffn_dim": 128, "num_kv_heads": 2}
INPUTS = ("data", "softmax_label")


def _lm(pkg, **over):
    return pkg.models.get_symbol("transformer-lm", scalar_loss=True,
                                 **dict(LM, **over))


def _mlp(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _bn_mlp(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = pkg.sym.BatchNorm(net, name="bn")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


# name -> (symbol builder, input shapes, label range)
MODELS = {
    "mlp": (_mlp, {"data": (8, 4), "softmax_label": (8,)}, 2),
    "bn_mlp": (_bn_mlp, {"data": (8, 4), "softmax_label": (8,)}, 2),
    "lm": (_lm, {"data": (2, 16), "softmax_label": (2, 16)},
           LM["num_classes"]),
}


def _values(model, seed=0):
    """Seeded numpy values of every argument of ``model``."""
    build, shapes, classes = MODELS[model]
    sym = build(mt)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    vals = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in INPUTS and (n == "softmax_label" or model == "lm"):
            v = rng.randint(0, classes, s)
        elif n.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        else:
            v = 0.3 * rng.randn(*s)
        vals[n] = v.astype(np.float32)
    return vals


def _bind(pkg, model, compute_dtype=None):
    build, shapes, _ = MODELS[model]
    sym = build(pkg)
    reqs = {n: ("null" if n in INPUTS else "write")
            for n in sym.list_arguments()}
    exe = sym.simple_bind(pkg.cpu(), grad_req=reqs,
                          compute_dtype=compute_dtype, **shapes)
    exe.copy_params_from(_values(model))
    return exe, [n for n in sym.list_arguments() if reqs[n] != "null"]


def _jax_step(model, make_opt, steps, chain=1, compute_dtype=None):
    """The reference's make_train_step with ``make_opt``'s pure rule and
    per-parameter lr / wd arrays; (losses, params, aux) after ``steps``
    calls."""
    import jax.numpy as jnp

    exe, names = _bind(mx, model, compute_dtype)
    opt = make_opt(mx, names)
    rule = opt.pure_rule()

    def update_fn(params, grads, states, lr_arr, wd_arr):
        new_p, new_s = {}, {}
        for pos, n in enumerate(names):
            new_p[n], new_s[n] = rule(params[n], grads[n], states[n],
                                      lr_arr[pos], wd_arr[pos])
        return new_p, new_s

    step = exe.make_train_step(update_fn, chain=chain)
    params = {n: jnp.array(exe.arg_dict[n]._data, copy=True) for n in names}
    states = {n: mx.optimizer.state_leaves(
        opt.create_state(i, exe.arg_dict[n]), copy=True)
        for i, n in enumerate(names)}
    losses = []
    for _ in range(steps):
        for _sub in range(chain):
            for i in range(len(names)):
                opt._update_count(i)
        lw = np.array([opt.effective_lr_wd(i) for i in range(len(names))],
                      np.float32)
        outs, params, states = step(params, states, {},
                                    jnp.asarray(lw[:, 0]),
                                    jnp.asarray(lw[:, 1]))
        losses.append(np.asarray(outs[0], np.float32))
    return (losses, {n: np.asarray(params[n]) for n in names},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()})


def _port_step(model, make_opt, steps, chain=1, compute_dtype=None,
               exe=None):
    """The port's make_train_step, as :func:`_jax_step`; also returns the
    step."""
    if exe is None:
        exe, names = _bind(mt, model, compute_dtype)
    else:
        names = [n for n in exe.arg_dict if exe.grad_req[n] != "null"]
    opt = make_opt(mt, names)
    rule = opt.pure_rule()
    updater = topt.Updater(opt)

    def update_fn(params, grads, states, lr_arr, wd_arr):
        new_p, new_s = {}, {}
        for pos, n in enumerate(names):
            new_p[n], new_s[n] = rule(params[n], grads[n], states[n],
                                      lr_arr[pos], wd_arr[pos])
        return new_p, new_s

    step = exe.make_train_step(update_fn, chain=chain)
    params = {n: exe.arg_dict[n]._data for n in names}
    states = {n: topt.state_leaves(updater.ensure_state(i, exe.arg_dict[n]))
              for i, n in enumerate(names)}
    losses, cache = [], None
    for _ in range(steps):
        for _sub in range(chain):
            for i in range(len(names)):
                opt._update_count(i)
        lr_arr, wd_arr, cache = topt.cached_lr_wd_arrays(
            cache, [opt.effective_lr_wd(i) for i in range(len(names))],
            exe.arg_dict[names[0]]._data.device)
        outs, params, states = step(params, states, None, lr_arr, wd_arr)
        losses.append(outs[0].numpy())
    return (losses, {n: exe.arg_dict[n].asnumpy() for n in names},
            {n: a.asnumpy() for n, a in exe.aux_dict.items()}), step


def _sgd(pkg, names):
    return pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                             param_idx2name=dict(enumerate(names)))


def _adam(pkg, names):
    return pkg.optimizer.Adam(learning_rate=0.01, wd=1e-3,
                              param_idx2name=dict(enumerate(names)))


def _plain_sgd(pkg, names):
    return pkg.optimizer.SGD(learning_rate=0.1,
                             param_idx2name=dict(enumerate(names)))


OPTS = {"sgd_momentum": _sgd, "adam": _adam, "sgd": _plain_sgd}


# --- make_train_step against the reference's ---------------------------------
@pytest.mark.parametrize("model", ["mlp", "lm"])
@pytest.mark.parametrize("opt", ["sgd_momentum", "adam"])
def test_make_train_step_matches_jax(model, opt):
    (got_l, got_p, _), step = _port_step(model, OPTS[opt], 3)
    want_l, want_p, _ = _jax_step(model, OPTS[opt], 3)
    assert step.stats()["path"] == "eager"
    tol = ADAM_TOL if opt == "adam" else STEP_TOL
    np.testing.assert_allclose(np.ravel(got_l)[:1], np.ravel(want_l)[:1],
                               **STEP_TOL)
    for n, w in want_p.items():
        np.testing.assert_allclose(got_p[n], w, err_msg=n, **tol)


def test_make_train_step_chain_2_equals_two_calls_and_jax():
    (_, p_chain, a_chain), _ = _port_step("bn_mlp", _sgd, 1, chain=2)
    (_, p_calls, a_calls), _ = _port_step("bn_mlp", _sgd, 2)
    for n in p_calls:
        np.testing.assert_array_equal(p_chain[n], p_calls[n], err_msg=n)
    for n in a_calls:
        np.testing.assert_array_equal(a_chain[n], a_calls[n], err_msg=n)
    _, w_p, w_a = _jax_step("bn_mlp", _sgd, 1, chain=2)
    for n in w_p:
        np.testing.assert_allclose(p_chain[n], w_p[n], err_msg=n, **STEP_TOL)


def test_make_train_step_threads_batchnorm_aux_like_jax():
    (_, got_p, got_a), _ = _port_step("bn_mlp", _sgd, 3)
    _, want_p, want_a = _jax_step("bn_mlp", _sgd, 3)
    assert set(got_a) == {"bn_moving_mean", "bn_moving_var"}
    for n, w in want_a.items():
        np.testing.assert_allclose(got_a[n], w, err_msg=n, **STEP_TOL)
    init = _values("bn_mlp")
    assert not np.array_equal(got_p["fc1_weight"], init["fc1_weight"])


def test_make_train_step_owns_its_buffers_and_copies_other_tensors_in():
    exe, names = _bind(mt, "mlp")

    def sgd(params, grads, states):
        return {n: params[n] - 0.1 * grads[n] for n in params}, states

    step = exe.make_train_step(sgd)
    params = {n: exe.arg_dict[n]._data for n in names}
    outs, new_p, _ = step(params, None, {})
    assert all(new_p[n] is params[n] for n in names)  # adopted, in place
    kept = outs[0].clone()
    copies = {n: t.clone() for n, t in new_p.items()}
    outs2, new_p2, _ = step(copies, None, {})     # other tensors: copied in
    assert all(new_p2[n] is params[n] for n in names)
    torch.testing.assert_close(outs[0], kept, rtol=0, atol=0)
    assert not torch.equal(copies["fc1_weight"], new_p2["fc1_weight"])
    with pytest.raises(MXNetError):
        step({}, None, {})
    with pytest.raises(MXNetError):
        step(params, None, {"fc1_weight": np.zeros((16, 4), np.float32)})


def test_make_train_step_takes_the_feed_and_refuses_a_mesh():
    exe, names = _bind(mt, "mlp")
    x = np.random.RandomState(3).uniform(-1, 1, (8, 4)).astype(np.float32)

    def keep(params, grads, states):
        return params, states

    step = exe.make_train_step(keep)
    outs, _, _ = step({n: exe.arg_dict[n]._data for n in names}, None,
                      {"data": x})
    np.testing.assert_array_equal(exe.arg_dict["data"].asnumpy(), x)
    want = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_array_equal(outs[0].numpy(), want)
    with pytest.raises(MXNetError):
        exe.make_train_step(keep, mesh=[0, 1])


# --- compute_dtype="bfloat16" ------------------------------------------------
def _fwd_bwd(pkg, model, compute_dtype):
    exe, names = _bind(pkg, model, compute_dtype)
    outs = exe.forward_backward()
    return ([o.asnumpy() for o in outs],
            {n: exe.grad_dict[n].asnumpy() for n in names})


def _dist(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_bf16_forward_backward_matches_jax_bf16(model):
    got_o, got_g = _fwd_bwd(mt, model, "bfloat16")
    want_o, want_g = _fwd_bwd(mx, model, "bfloat16")
    _, f32_g = _fwd_bwd(mx, model, None)
    for g, w in zip(got_o, want_o):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=BF16_TOL["out"], atol=1e-6)
    for n, w in want_g.items():
        assert got_g[n].dtype == np.float32, n
        assert _dist(got_g[n], w) <= BF16_TOL["spread"] * _dist(
            w, f32_g[n]), n


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_bf16_train_step_matches_jax_bf16(model):
    (got_l, got_p, _), _ = _port_step(model, _sgd, 3,
                                      compute_dtype="bfloat16")
    want_l, want_p, _ = _jax_step(model, _sgd, 3, compute_dtype="bfloat16")
    _, f32_p, _ = _jax_step(model, _sgd, 3)
    np.testing.assert_allclose([np.ravel(x)[0] for x in got_l],
                               [np.ravel(x)[0] for x in want_l],
                               rtol=BF16_TOL["loss"])
    assert max(_dist(got_p[n], want_p[n]) for n in want_p) <= \
        BF16_TOL["spread"] * max(_dist(want_p[n], f32_p[n]) for n in want_p)


def test_bf16_against_f32_in_the_port():
    """As ``tests/test_executor.py``'s bf16 test: f32 outputs and
    gradients, within bf16's reach of the f32 executor's."""
    o32, g32 = _fwd_bwd(mt, "mlp", None)
    o16, g16 = _fwd_bwd(mt, "mlp", "bfloat16")
    np.testing.assert_allclose(o16[0], o32[0], atol=2e-2)
    for n in g32:
        assert g16[n].dtype == np.float32
        np.testing.assert_allclose(g16[n], g32[n], atol=3e-2, err_msg=n)


def test_compute_dtype_through_bind_module_and_the_environment(monkeypatch):
    sym = _mlp(mt)
    vals = _values("mlp")
    args = {n: mt.nd.array(v, mt.cpu()) for n, v in vals.items()}
    exe = sym.bind(mt.cpu(), args, compute_dtype="bfloat16")
    assert exe.compute_dtype == torch.bfloat16
    assert exe.forward()[0].asnumpy().dtype == np.float32
    assert sym.bind(mt.cpu(), args).compute_dtype is None
    monkeypatch.setenv("MXNET_COMPUTE_DTYPE", "bfloat16")
    assert sym.simple_bind(mt.cpu(), data=(8, 4),
                           softmax_label=(8,)).compute_dtype == torch.bfloat16
    monkeypatch.delenv("MXNET_COMPUTE_DTYPE")
    mod = mt.mod.Module(sym, context=mt.cpu(), compute_dtype="bfloat16")
    mod.bind([("data", (8, 4))], [("softmax_label", (8,))])
    assert mod._exec_group._exec.compute_dtype == torch.bfloat16


# --- ids and labels at vocab 10000 under bf16 --------------------------------
def test_bf16_keeps_ids_and_labels_exact_at_vocab_10000():
    vocab, dim = 10000, 8
    data = mt.sym.Variable("data")
    emb = mt.sym.Embedding(data, input_dim=vocab, output_dim=dim,
                           name="embed")
    pred = mt.sym.FullyConnected(mt.sym.Reshape(emb, shape=(-1, dim)),
                                 num_hidden=vocab, name="pred")
    label = mt.sym.Reshape(mt.sym.Variable("softmax_label"), shape=(-1,))
    head = mt.sym.SoftmaxOutput(pred, label, name="softmax")
    group = mt.sym.Group([head, mt.sym.BlockGrad(emb)])
    exe = group.simple_bind(mt.cpu(), compute_dtype="bfloat16",
                            grad_req={"pred_weight": "write"},
                            data=(2, 3), softmax_label=(2, 3))
    assert exe._index_only == {"data", "softmax_label"}
    ids = np.array([[9999, 4097, 257], [8191, 5, 7001]], np.float32)
    labels = np.array([[9997, 4099, 259], [8193, 3, 7003]], np.float32)
    rng = np.random.RandomState(0)
    table = rng.randn(vocab, dim).astype(np.float32)
    exe.copy_params_from({"data": ids, "softmax_label": labels,
                          "embed_weight": table,
                          "pred_weight": 0.01 * rng.randn(vocab, dim)
                          .astype(np.float32),
                          "pred_bias": np.zeros(vocab, np.float32)})
    outs = exe.forward_backward()
    # the lookup: the f32 table's rows at the exact ids, rounded to bf16
    want = torch.tensor(table)[torch.tensor(ids).long()].to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(outs[1].asnumpy(), want)
    # the head's gradient is p - onehot(label): -1 sits at the exact label
    prob = outs[0].asnumpy()
    grad_rows = prob - np.eye(vocab, dtype=np.float32)[
        labels.reshape(-1).astype(int)]
    assert list(np.argmin(grad_rows, axis=1)) == list(
        labels.reshape(-1).astype(int))
    lm = mt.models.get_symbol("transformer-lm", scalar_loss=True,
                              num_classes=vocab, **{k: v for k, v in
                                                    LM.items()
                                                    if k != "num_classes"})
    lm_exe = lm.simple_bind(mt.cpu(), compute_dtype="bfloat16",
                            data=(1, 4), softmax_label=(1, 4))
    assert lm_exe._index_only == {"data", "softmax_label"}


def test_bf16_keeps_ssd_boxes_exact_for_matching():
    """SSD's label feeds only MultiBoxTarget's label slot, so under bf16
    compute its box coordinates stay f32 (the JAX package casts them to
    bf16): the class targets and the location loss's mask are those of the
    f32 executor on the same label, to the bit, for boxes bf16 cannot
    hold."""
    from mxnet_tpu_torch.tools.ssd import ssd_labels

    with mt.name.NameManager():
        sym = mt.models.get_symbol("ssd-vgg16", num_classes=3)
    internals = sym.get_internals()
    group = mt.sym.Group([internals["multibox_target_output1"],
                          internals["multibox_target_output2"]])
    rng = np.random.RandomState(1)
    label = ssd_labels(rng, 2, 8, 3)
    assert (label != torch.tensor(label).to(torch.bfloat16).float()
            .numpy()).any()
    outs = []
    for dtype in (None, "bfloat16"):
        exe = group.simple_bind(mt.cpu(), compute_dtype=dtype,
                                grad_req="null", data=(2, 3, 64, 64),
                                label=label.shape)
        if dtype:
            assert "label" in exe._index_only
        exe.arg_dict["label"][:] = label
        outs.append([o.asnumpy() for o in exe.forward(is_train=False)])
    assert (outs[0][1] > 0).any()
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


# --- the fused Module.fit against the reference's fused Module.fit -----------
def _module_fit(pkg, opt, model="mlp", batches=3, fused=True,
                mutate=None, compute_dtype=None):
    """Module.fit of a BatchNorm MLP over ``batches`` batches of 8 from
    seeded weights; (params, aux, module). ``mutate(module)`` runs after
    the first batch."""
    os.environ["MXNET_FUSED_FIT"] = "1" if fused else "0"
    try:
        sym = MODELS[model][0](pkg)
        rng = np.random.RandomState(2)
        x = rng.uniform(-1, 1, (8 * batches, 4)).astype(np.float32)
        y = rng.randint(0, 2, 8 * batches).astype(np.float32)
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        kw = {} if compute_dtype is None else {
            "compute_dtype": compute_dtype}
        mod = pkg.mod.Module(sym, context=pkg.cpu(), **kw)
        mod.bind(it.provide_data, it.provide_label)
        vals = _values(model)
        aux_shapes = sym.infer_shape(data=(8, 4))[2]
        mod.init_params(
            arg_params={n: pkg.nd.array(v, pkg.cpu())
                        for n, v in vals.items() if n not in INPUTS},
            aux_params={n: (pkg.nd.ones if "var" in n else pkg.nd.zeros)(
                s, pkg.cpu()) for n, s in zip(sym.list_auxiliary_states(),
                                              aux_shapes)})
        params = {"sgd_momentum": (("learning_rate", 0.1), ("momentum", 0.9),
                                   ("wd", 1e-3)),
                  "sgd": (("learning_rate", 0.1),),
                  "adam": (("learning_rate", 0.01), ("wd", 1e-3))}[opt]
        calls = []

        def after(param):
            calls.append(param.nbatch)
            if mutate is not None and param.nbatch == 0:
                mutate(mod)

        mod.fit(it, num_epoch=1, optimizer=opt.split("_")[0],
                optimizer_params=params, batch_end_callback=after)
        args, aux = mod.get_params()
        return ({n: a.asnumpy() for n, a in args.items()},
                {n: a.asnumpy() for n, a in aux.items()}, mod)
    finally:
        del os.environ["MXNET_FUSED_FIT"]


# Adam on the MLP without BatchNorm: a bias before BatchNorm has a zero
# gradient up to rounding, which Adam scales up to steps of size lr
@pytest.mark.parametrize("opt,model", [("sgd_momentum", "bn_mlp"),
                                       ("adam", "mlp")])
def test_fused_module_fit_matches_jax_fused_fit(opt, model):
    got_p, got_a, mod = _module_fit(mt, opt, model=model)
    want_p, want_a, _ = _module_fit(mx, opt, model=model)
    assert mod.fit_step_stats()["path"] == "eager"
    tol = ADAM_TOL if opt == "adam" else STEP_TOL
    for n, w in want_p.items():
        np.testing.assert_allclose(got_p[n], w, err_msg=n, **tol)
    for n, w in want_a.items():
        np.testing.assert_allclose(got_a[n], w, err_msg=n, **STEP_TOL)


# --- fused against unfused, bit for bit --------------------------------------
@pytest.mark.parametrize("opt", ["sgd_momentum", "adam", "sgd"])
def test_fused_fit_equals_unfused_bit_for_bit(opt):
    got_p, got_a, fused = _module_fit(mt, opt, model="bn_mlp", batches=4)
    want_p, want_a, plain = _module_fit(mt, opt, model="bn_mlp", batches=4,
                                        fused=False)
    assert fused.fit_step_stats()["path"] == "eager"
    assert plain.fit_step_stats() == {"path": "unfused",
                                      "reason": "MXNET_FUSED_FIT=0"}
    for n in want_p:
        np.testing.assert_array_equal(got_p[n], want_p[n], err_msg=n)
    for n in want_a:
        np.testing.assert_array_equal(got_a[n], want_a[n], err_msg=n)


def test_fused_fit_bf16_equals_unfused_bf16():
    got_p, _, _ = _module_fit(mt, "sgd_momentum", model="bn_mlp",
                              compute_dtype="bfloat16")
    want_p, _, _ = _module_fit(mt, "sgd_momentum", model="bn_mlp",
                               compute_dtype="bfloat16", fused=False)
    for n in want_p:
        np.testing.assert_array_equal(got_p[n], want_p[n], err_msg=n)


# --- changes between steps reach the fused step ------------------------------
def _double_lr(mod):
    mod._optimizer.lr_mult["fc1_weight"] = 2.0   # in place, no setter


def test_in_place_lr_mult_reaches_the_fused_step():
    got, _, _ = _module_fit(mt, "sgd_momentum", model="bn_mlp",
                            mutate=_double_lr)
    want, _, _ = _module_fit(mt, "sgd_momentum", model="bn_mlp",
                             mutate=_double_lr, fused=False)
    unchanged, _, _ = _module_fit(mt, "sgd_momentum", model="bn_mlp")
    np.testing.assert_array_equal(got["fc1_weight"], want["fc1_weight"])
    assert not np.array_equal(got["fc1_weight"], unchanged["fc1_weight"])


def _reset_fc2(mod):
    args, aux = mod.get_params()
    args = dict(args, fc2_weight=mt.nd.zeros(args["fc2_weight"].shape,
                                              mt.cpu()))
    mod.set_params(args, aux)


def _more_momentum(mod):
    mod._optimizer.momentum = 0.5


def _add_momentum(mod):
    mod._optimizer.momentum = 0.9   # None states become buffers


@pytest.mark.parametrize("opt,mutate", [("sgd_momentum", _reset_fc2),
                                        ("sgd_momentum", _more_momentum),
                                        ("sgd", _add_momentum)])
def test_set_params_and_hyperparameters_reach_the_fused_step(opt, mutate):
    got, _, mod = _module_fit(mt, opt, model="bn_mlp", mutate=mutate)
    want, _, _ = _module_fit(mt, opt, model="bn_mlp", mutate=mutate,
                             fused=False)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert mod.fit_step_stats()["path"] == "eager"


def test_init_optimizer_again_rebuilds_the_fused_step():
    _, _, mod = _module_fit(mt, "sgd_momentum", model="bn_mlp")
    first = mod._fused_fit["step"]
    mod.init_optimizer(optimizer="adam", force_init=True)
    assert mod._fused_fit is None
    it = mt.io.NDArrayIter(np.zeros((8, 4), np.float32),
                           np.zeros(8, np.float32), batch_size=8)
    mod.fit_step(next(iter(it)))
    assert mod._fused_fit["step"] is not first


def test_ineligible_fit_step_records_why():
    class Cube(mt.operator.PythonOp):
        def forward_np(self, in_data, out_data):
            out_data[0][:] = in_data[0] ** 3

        def backward_np(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 3 * in_data[0] ** 2 * out_grad[0]

    @mt.operator.register("train_step_cube")
    class CubeProp(mt.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, in_shape, []

        def create_operator(self, ctx, shapes, dtypes):
            return Cube()

    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc")
    net = mt.sym.Custom(net, op_type="train_step_cube")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    it = mt.io.NDArrayIter(np.ones((8, 4), np.float32),
                           np.zeros(8, np.float32), batch_size=4)
    mod.fit(it, num_epoch=1, optimizer="sgd")
    stats = mod.fit_step_stats()
    assert stats["path"] == "unfused"
    assert "copies to the host (Cube)" in stats["reason"]
    fixed = mt.mod.Module(_mlp(mt), context=mt.cpu(),
                          fixed_param_names=["fc1_bias"])
    fixed.fit(mt.io.NDArrayIter(np.ones((8, 4), np.float32),
                                np.zeros(8, np.float32), batch_size=4),
              num_epoch=1, optimizer="sgd")
    assert fixed.fit_step_stats() == {
        "path": "unfused", "reason": "a parameter's grad_req is not write"}


# --- the device-lr updates equal the scalar ones -----------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_lr_plain_updates_equal_scalar_ones(dtype):
    g = torch.Generator().manual_seed(0)
    w, gr, m, v = (torch.randn(257, generator=g).to(dtype) for _ in range(4))
    v = v.abs()
    lr = torch.tensor([0.1, 0.0371, 0.5], dtype=torch.float32)
    wd = torch.tensor([1e-4, 3e-3, 0.0], dtype=torch.float32)
    a = [t.clone() for t in (w, gr, m)]
    b = [t.clone() for t in (w, gr, m)]
    fu.sgd_mom_update(*a, float(lr[1]), 0.9, float(wd[1]), 0.5, 0.8)
    fu.sgd_mom_update_lr(*b, lr, wd, 1, 0.9, 0.5, 0.8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a = [t.clone() for t in (w, gr, m, v)]
    b = [t.clone() for t in (w, gr, m, v)]
    fu.adam_update(*a, float(lr[2]), 0.9, 0.999, 1e-8, float(wd[0]), 0.5,
                   -1.0)
    fu.adam_update_lr(*b, lr, torch.tensor([0.0, 0.0, float(wd[0])]), 2,
                      0.9, 0.999, 1e-8, 0.5, -1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fu.sgd_mom_update_lr.launches == 0 == fu.adam_update_lr.launches
    with pytest.raises(IndexError):
        fu.sgd_mom_update_lr(*b[:3], lr, wd, 3)
    with pytest.raises(ValueError):
        fu.sgd_mom_update_lr(*b[:3], lr.double(), wd, 0)


def test_pure_rules_equal_the_updater_bit_for_bit():
    for make in OPTS.values():
        names = ["w_weight"]
        rng = np.random.RandomState(1)
        w0 = rng.randn(33).astype(np.float32)
        grads = [rng.randn(33).astype(np.float32) for _ in range(3)]
        outs = []
        for fused in (True, False):
            opt = make(mt, names)
            upd = topt.Updater(opt)
            w = mt.nd.array(w0, mt.cpu())
            rule = opt.pure_rule()
            for g in grads:
                g = mt.nd.array(g, mt.cpu())
                if fused:
                    st = upd.ensure_state(0, w)
                    opt._update_count(0)
                    lr, wd = opt.effective_lr_wd(0)
                    new_w, _ = rule(w._data, g._data, topt.state_leaves(st),
                                    torch.tensor(lr, dtype=torch.float32),
                                    torch.tensor(wd, dtype=torch.float32))
                    w._data.copy_(new_w)
                else:
                    upd(0, g, w)
            outs.append(w.asnumpy())
        np.testing.assert_array_equal(outs[0], outs[1])


def test_hyperparam_key_and_lr_wd_arrays_key_on_contents():
    opt = mt.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    key = opt._hyperparam_key()
    opt.lr = 0.2
    opt.lr_mult["x"] = 3.0
    assert opt._hyperparam_key() == key
    opt.momentum = 0.5
    assert opt._hyperparam_key() != key
    lw = np.array([[0.1, 0.0], [0.2, 1e-4]], np.float32)
    lr, wd, cache = topt.cached_lr_wd_arrays(None, lw, torch.device("cpu"))
    lr2, _, cache2 = topt.cached_lr_wd_arrays(cache, lw.copy(),
                                              torch.device("cpu"))
    assert lr2 is lr and cache2 is cache
    lw[1, 0] = 0.4
    lr3, _, _ = topt.cached_lr_wd_arrays(cache, lw, torch.device("cpu"))
    assert lr3 is not lr and float(lr3[1]) == np.float32(0.4)


# --- launch counts across replays --------------------------------------------
def test_replay_launch_accounting_on_a_stand_in_graph():
    """A stand-in for a CUDA graph: recording runs the wrappers' Python
    (each counts as if it launched) and launches nothing; a replay runs
    no Python. The capture adds nothing; each replay adds one step's."""
    def kernel_a():
        kernel_a.launches += 1

    def kernel_b():
        kernel_b.launches += 1

    _launches.counted(kernel_a)
    _launches.counted(kernel_b)
    kernel_a()                                    # a warm-up call: counts

    class StandInGraph:
        def __init__(self):
            self.recorded = []

        def record(self, fn):
            self.recorded.append(fn)
            fn()                                  # Python runs, counts

        def replay(self):
            pass                                  # the card only

    graph = StandInGraph()
    delta = _launches.capture(lambda: graph.record(
        lambda: [kernel_a(), kernel_b(), kernel_b()]))
    assert (kernel_a.launches, kernel_b.launches) == (1, 0)
    assert delta == {kernel_a: 1, kernel_b: 2}
    for _ in range(3):
        graph.replay()
        _launches.replayed(delta)
    assert (kernel_a.launches, kernel_b.launches) == (4, 6)
    snap = _launches.snapshot()
    assert snap[kernel_a] == 4 and fu.sgd_mom_update in snap


def test_replays_count_launches_by_type():
    """A wrapper that counts by type (``launched``) keeps those counts
    exact across a capture and its replays too."""
    def kernel():
        pass

    _launches.counted(kernel)
    _launches.launched(kernel, torch.float32)     # a warm-up call
    delta = _launches.capture(lambda: [
        _launches.launched(kernel, torch.bfloat16) for _ in range(2)])
    assert kernel.launches_by_dtype == {"float32": 1}
    assert delta == {kernel: 2, (kernel, "bfloat16"): 2}
    _launches.replayed(delta, times=3)
    assert kernel.launches == 7
    assert kernel.launches_by_dtype == {"float32": 1, "bfloat16": 6}
    _launches.reset(kernel)
    assert (kernel.launches, kernel.launches_by_dtype) == (0, {})


def test_a_failed_capture_leaves_the_counters_as_they_were():
    def kernel():
        kernel.launches += 1

    _launches.counted(kernel)

    def broken():
        kernel()
        raise RuntimeError("capture refused")

    with pytest.raises(RuntimeError):
        _launches.capture(broken)
    assert kernel.launches == 0


# --- nd.array copies; slice_axis from a negative begin; 2 ** a, 7 % a --------
def test_nd_array_copies_its_numpy_source():
    for write in (lambda pkg, a: a.__setitem__(slice(None), 1),
                  lambda pkg, a: a.__setitem__(0, 1),
                  lambda pkg, a: a.__iadd__(1),
                  lambda pkg, a: pkg.nd.sqrt(a, out=a)):
        arrays = []
        for pkg in (mt, mx):
            x = np.arange(24, dtype="f4")
            a = pkg.nd.array(x, ctx=pkg.cpu())
            write(pkg, a)
            np.testing.assert_array_equal(x, np.arange(24, dtype="f4"))
            x[0] = 99
            assert a.asnumpy()[0] != 99
            arrays.append(a.asnumpy())
        np.testing.assert_array_equal(arrays[0], arrays[1])


@pytest.mark.parametrize("begin,end", [(-3, None), (-2, -1), (1, -1),
                                       (-5, 3)])
def test_slice_axis_with_a_negative_begin(begin, end):
    x = np.arange(20, dtype=np.float32).reshape(4, 5)
    got = mt.nd.slice_axis(mt.nd.array(x, mt.cpu()), axis=1, begin=begin,
                           end=end).asnumpy()
    want = mx.nd.slice_axis(mx.nd.array(x, mx.cpu()), axis=1, begin=begin,
                            end=end).asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x[:, begin:end])
    tsym = mt.sym.slice_axis(mt.sym.Variable("data"), axis=1, begin=begin,
                             end=end)
    jsym = mx.sym.slice_axis(mx.sym.Variable("data"), axis=1, begin=begin,
                             end=end)
    assert tsym.infer_shape(data=(4, 5))[1] == \
        jsym.infer_shape(data=(4, 5))[1] == [want.shape]


def test_ndarray_rpow_and_rmod():
    x = np.array([1, 2, 4, 5], np.float32)
    a, r = mt.nd.array(x, mt.cpu()), mx.nd.array(x, mx.cpu())
    np.testing.assert_array_equal((2 ** a).asnumpy(), (2 ** r).asnumpy())
    np.testing.assert_array_equal((7 % a).asnumpy(), (7 % r).asnumpy())
    np.testing.assert_array_equal((2 ** a).asnumpy(), [2, 4, 16, 32])
