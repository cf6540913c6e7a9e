"""The port's optimizer zoo against the JAX package's, on the CPU.

Every optimizer of the JAX package's registry is created by name in both
packages and stepped 3 times on the same two seeded parameters (a weight
and a bias, so ``set_wd_mult`` leaves the bias undecayed), with wd,
``rescale_grad``, ``lr_mult`` on the weight and a ``FactorScheduler``:

- the eager path, each package's ``Updater``, at clip 0.3, None and 0;
- the pure-rule path, the port's ``FusedUpdate`` (what a captured
  ``fit_step`` runs) against the JAX package's ``Updater.update_all``
  (its jitted pure rule), for every optimizer that has one.

Weights and states agree within f32 rounding: rtol 1e-5, atol 1e-6 (both
sides compute the same f32 expressions; only the order of a few products
may differ). SGLD is held with each side's noise drawn again from its
seed and subtracted. A JAX ``get_states()`` blob loaded into the port
(and the port's into the JAX package) continues identically.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-6
NAMES = {0: "fc_weight", 1: "fc_bias"}
SHAPES = {0: (6, 5), 1: (6,)}
STEPS = 3

# name -> (registry name, hyperparameters beyond the common ones)
CASES = {
    "sgd": ("sgd", {"momentum": 0.9}),
    "sgd_plain": ("sgd", {}),
    "nag": ("nag", {"momentum": 0.9}),
    "nag_plain": ("nag", {}),
    "ccsgd": ("ccsgd", {"momentum": 0.9}),
    "dcasgd": ("dcasgd", {"momentum": 0.9, "lamda": 0.5}),
    "dcasgd_plain": ("dcasgd", {"lamda": 0.5}),
    "adam": ("adam", {}),
    "adagrad": ("adagrad", {"eps": 1e-6}),
    "rmsprop": ("rmsprop", {}),
    "rmsprop_centered": ("rmsprop", {"centered": True, "gamma2": 0.8,
                                     "clip_weights": 0.35}),
    "adadelta": ("adadelta", {"rho": 0.85}),
    "ftrl": ("ftrl", {"lamda1": 0.02, "beta": 1.5}),
    "test": ("test", {}),
}
PURE = sorted(k for k, (n, _) in CASES.items()
              if n in ("sgd", "nag", "ccsgd", "adam", "adagrad", "rmsprop",
                       "adadelta"))
REGISTRY = ("sgd", "nag", "sgld", "ccsgd", "dcasgd", "adam", "adagrad",
            "rmsprop", "adadelta", "ftrl", "test")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    w = {i: rng.uniform(-0.5, 0.5, s).astype(np.float32)
         for i, s in SHAPES.items()}
    g = [{i: rng.uniform(-1, 1, s).astype(np.float32)
          for i, s in SHAPES.items()} for _ in range(STEPS)]
    return w, g


def _optimizer(pkg, case, clip):
    name, kw = CASES[case]
    opt = pkg.optimizer.create(
        name, learning_rate=0.05, wd=0.01, rescale_grad=0.5,
        clip_gradient=clip, param_idx2name=NAMES,
        lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5),
        **kw)
    opt.set_lr_mult({"fc_weight": 2.0})
    opt.set_wd_mult({})
    return opt


def _states(updater):
    """The updater's states as the JAX package's blob holds them."""
    blob = pickle.loads(updater.get_states())
    blob.pop("__update_counts__")
    return blob


def _close(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            _close(a, b, "%s[%d]" % (what, k))
    elif want is None:
        assert got is None, what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def _eager_run(pkg, case, clip, w0, grads, ctx):
    opt = _optimizer(pkg, case, clip)
    upd = pkg.optimizer.get_updater(opt)
    w = {i: pkg.nd.array(a, ctx=ctx) for i, a in w0.items()}
    hist = []
    for g in grads:
        for i in sorted(w):
            upd(i, pkg.nd.array(g[i], ctx=ctx), w[i])
        hist.append(({i: a.asnumpy() for i, a in w.items()}, _states(upd)))
    return hist, upd, w


@pytest.mark.parametrize("clip", [0.3, None, 0.0], ids=["clip", "none",
                                                         "zero"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_updater_equals_the_jax_package(case, clip):
    w0, grads = _inputs()
    got, _, _ = _eager_run(mt, case, clip, w0, grads, "cpu")
    want, _, _ = _eager_run(mx, case, clip, w0, grads, None)
    for step, ((gw, gs), (ww, ws)) in enumerate(zip(got, want)):
        for i in ww:
            _close(gw[i], ww[i], "%s step %d weight %d" % (case, step, i))
        assert sorted(gs) == sorted(ws)
        for i in ws:
            _close(gs[i], ws[i], "%s step %d state %d" % (case, step, i))
    # the run moved the weights
    assert not np.array_equal(got[-1][0][0], w0[0])


def _pure_run_port(case, clip, w0, grads):
    opt = _optimizer(mt, case, clip)
    upd = mt.optimizer.get_updater(opt)
    names = [NAMES[i] for i in sorted(w0)]
    weights = {NAMES[i]: mt.nd.array(a, ctx="cpu") for i, a in w0.items()}
    fused = mt.optimizer.FusedUpdate(upd, names, sorted(w0))
    params = {n: weights[n]._data for n in names}
    hist = []
    for g in grads:
        states = fused.states(weights)
        lr_arr, wd_arr = fused.lr_wd(torch.device("cpu"))
        gt = {NAMES[i]: torch.tensor(g[i]) for i in g}
        with torch.no_grad():
            new_p, new_s = fused(params, gt, states, lr_arr, wd_arr)
        for n in names:
            # a rule updates in place or returns new tensors
            params[n] = new_p[n]
            weights[n]._data = new_p[n]
            idx = sorted(w0)[names.index(n)]
            st = upd.states[idx]
            if isinstance(st, tuple):
                for nd_, t in zip(st, new_s[n]):
                    if nd_ is not None:
                        nd_._data = t
            elif st is not None:
                st._data = new_s[n]
        hist.append(({i: weights[NAMES[i]].asnumpy() for i in w0},
                     _states(upd)))
    return hist


def _pure_run_jax(case, clip, w0, grads):
    opt = _optimizer(mx, case, clip)
    assert opt.pure_rule() is not None
    upd = mx.optimizer.get_updater(opt)
    w = {i: mx.nd.array(a) for i, a in w0.items()}
    hist = []
    for g in grads:
        upd.update_all([(i, mx.nd.array(g[i]), w[i]) for i in sorted(w)])
        hist.append(({i: a.asnumpy() for i, a in w.items()}, _states(upd)))
    return hist


@pytest.mark.parametrize("clip", [0.3, None, 0.0], ids=["clip", "none",
                                                         "zero"])
@pytest.mark.parametrize("case", PURE)
def test_pure_rule_equals_the_jax_package(case, clip):
    """The rule a captured fit_step runs, against the JAX package's
    jitted pure rule (which clips only when clip > 0)."""
    w0, grads = _inputs(1)
    got = _pure_run_port(case, clip, w0, grads)
    want = _pure_run_jax(case, clip, w0, grads)
    for step, ((gw, gs), (ww, ws)) in enumerate(zip(got, want)):
        for i in ww:
            _close(gw[i], ww[i], "%s step %d weight %d" % (case, step, i))
        for i in ws:
            _close(gs[i], ws[i], "%s step %d state %d" % (case, step, i))


@pytest.mark.parametrize("case", ["nag", "adagrad", "adadelta"])
def test_clip_zero_differs_between_the_two_paths_in_both_packages(case):
    """A reference finding the port keeps: with clip_gradient=0 an eager
    update clamps every gradient to 0, a pure rule does not clip."""
    w0, grads = _inputs(2)
    for pkg, run_pure, ctx in ((mt, _pure_run_port, "cpu"),
                               (mx, _pure_run_jax, None)):
        eager, _, _ = _eager_run(pkg, case, 0.0, w0, grads, ctx)
        pure = run_pure(case, 0.0, w0, grads)
        assert not np.allclose(eager[-1][0][0], pure[-1][0][0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_states_cross_between_the_packages(case):
    """Two steps in one package, its get_states() blob and weights loaded
    into the other, one more step in both: equal. Both directions."""
    w0, grads = _inputs(3)
    for src, dst, src_ctx, dst_ctx in ((mx, mt, None, "cpu"),
                                       (mt, mx, "cpu", None)):
        _, src_upd, src_w = _eager_run(src, case, 0.3, w0, grads[:2],
                                       src_ctx)
        blob = src_upd.get_states()
        dst_opt = _optimizer(dst, case, 0.3)
        dst_upd = dst.optimizer.get_updater(dst_opt)
        dst_upd.set_states(blob)
        # the schedule reads num_update: both optimizers at the same count
        dst_opt.num_update = src_upd.optimizer.num_update
        dst_w = {i: dst.nd.array(a.asnumpy(), ctx=dst_ctx)
                 for i, a in src_w.items()}
        for i in sorted(w0):
            src_upd(i, src.nd.array(grads[2][i], ctx=src_ctx), src_w[i])
            dst_upd(i, dst.nd.array(grads[2][i], ctx=dst_ctx), dst_w[i])
        for i in w0:
            _close(dst_w[i].asnumpy(), src_w[i].asnumpy(),
                   "%s weight %d" % (case, i))
        want, got = _states(src_upd), _states(dst_upd)
        for i in want:
            _close(got[i], want[i], "%s state %d" % (case, i))


@pytest.mark.parametrize("clip", [0.3, None], ids=["clip", "none"])
def test_sgld_with_its_noise_subtracted_equals_the_jax_package(clip):
    """Each step from the same weights: the JAX package draws its noise
    from numpy's global state, the port from the CPU's generator; each
    side's noise, drawn again from its seed, is subtracted."""
    w0, grads = _inputs(4)
    opts = {pkg: pkg.optimizer.create(
        "sgld", learning_rate=0.05, wd=0.01, rescale_grad=0.5,
        clip_gradient=clip, param_idx2name=NAMES,
        lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5))
        for pkg in (mx, mt)}
    for opt in opts.values():
        opt.set_lr_mult({"fc_weight": 2.0})
        opt.set_wd_mult({})
    upds = {pkg: pkg.optimizer.get_updater(o) for pkg, o in opts.items()}
    cur = dict(w0)
    for step, g in enumerate(grads):
        seed = 100 + step
        out = {}
        for pkg, ctx in ((mx, None), (mt, "cpu")):
            w = {i: pkg.nd.array(a, ctx=ctx) for i, a in cur.items()}
            if pkg is mx:
                np.random.seed(seed)
            else:
                mt.random.seed(seed)
            lrs = {}
            for i in sorted(w):
                upds[pkg](i, pkg.nd.array(g[i], ctx=ctx), w[i])
                lrs[i] = opts[pkg]._get_lr(i)
            if pkg is mx:
                np.random.seed(seed)
                noise = {i: np.random.normal(0, np.sqrt(lrs[i]),
                                             SHAPES[i]).astype(np.float32)
                         for i in sorted(w)}
            else:
                mt.random.seed(seed)
                gen = mt.random.generator("cpu")
                noise = {i: (torch.randn(SHAPES[i], generator=gen)
                             * np.sqrt(lrs[i])).numpy()
                         for i in sorted(w)}
            out[pkg] = {i: w[i].asnumpy() - noise[i] for i in w}
            assert lrs == {0: 0.1 * 0.5 ** (step // 2),
                           1: 0.05 * 0.5 ** (step // 2)}
        for i in w0:
            np.testing.assert_allclose(out[mt][i], out[mx][i], rtol=RTOL,
                                       atol=ATOL)
        cur = {i: out[mx][i] for i in w0}


def test_sgld_noise_has_variance_lr_and_follows_the_seed():
    """At g = 0 and wd = 0 one update adds N(0, lr): over 2^16 elements
    the mean within 5 sigma of 0 and the variance within 5 sigma of lr;
    one seed twice the same, two seeds different."""
    n, lr = 1 << 16, 0.02

    def step(seed):
        mt.random.seed(seed)
        opt = mt.optimizer.create("sgld", learning_rate=lr)
        w = mt.nd.zeros((n,), ctx="cpu")
        mt.optimizer.get_updater(opt)(0, mt.nd.zeros((n,), ctx="cpu"), w)
        return w.asnumpy().astype(np.float64)

    a, b, c = step(7), step(7), step(8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert abs(a.mean()) <= 5 * np.sqrt(lr / n)
    assert abs(a.var() - lr) <= 5 * np.sqrt(2 * lr * lr / n)


@pytest.mark.parametrize("attrs", [
    {},
    {"lr": 0.02, "wd": 0.1, "rescale_grad": 0.25, "gamma1": 0.8},
    {"clip_gradient": 0.2, "clip_weights": 0.3, "epsilon": 1e-4},
])
def test_rmsprop_ops_equal_the_jax_package(attrs):
    rng = np.random.RandomState(5)
    w, g, n, gs = (rng.uniform(-1, 1, (7, 9)).astype(np.float32)
                   for _ in range(4))
    n = np.abs(n)
    delta = rng.uniform(-0.1, 0.1, (7, 9)).astype(np.float32)
    for op, ins in (("rmsprop_update", (w, g, n)),
                    ("rmspropalex_update", (w, g, n + 1.0, gs * 0.1,
                                            delta))):
        got = getattr(mt.nd, op)(*[mt.nd.array(x, ctx="cpu") for x in ins],
                                 **attrs)
        want = getattr(mx.nd, op)(*[mx.nd.array(x) for x in ins], **attrs)
        assert len(got) == len(want) == len(ins) - 1
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL,
                                       atol=ATOL)


def test_rmsprop_defaults_follow_the_reference():
    """The op's gamma1 is 0.95, the optimizer's 0.9, as in the reference."""
    from mxnet_tpu_torch.ops import get_op

    assert get_op("rmsprop_update").parse_attrs({})["gamma1"] == 0.95
    assert get_op("rmspropalex_update").parse_attrs({})["gamma2"] == 0.9
    assert mt.optimizer.create("rmsprop").gamma1 == 0.9


def test_every_registered_optimizer_is_created_by_name():
    for name in REGISTRY:
        opt = mt.optimizer.create(name)
        assert type(opt).__name__.lower() == name
        assert type(opt).__name__ == type(mx.optimizer.create(name)).__name__
    has_rule = {n for n in REGISTRY
                if mt.optimizer.create(n).pure_rule() is not None}
    want = {n for n in REGISTRY
            if mx.optimizer.create(n).pure_rule() is not None}
    assert has_rule == want == {"sgd", "nag", "ccsgd", "adam", "adagrad",
                                "rmsprop", "adadelta"}


def _mlp(pkg):
    d = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data=d, num_hidden=6,
                                                  name="fc1"),
                           act_type="tanh")
    h = pkg.sym.FullyConnected(data=h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(data=h, name="softmax")


def _batches(pkg):
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (12, 5)).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    return list(pkg.io.NDArrayIter(x, y, batch_size=4))


@pytest.mark.parametrize("case", ["dcasgd", "rmsprop_centered", "ftrl"])
def test_module_checkpoint_with_states_crosses_the_packages(case, tmp_path):
    """Two updates in one package's Module, ``save_checkpoint(...,
    save_optimizer_states=True)``, ``Module.load(...,
    load_optimizer_states=True)`` in the other, one more update in both:
    equal. Both directions."""
    name, kw = CASES[case]
    params = dict(kw, learning_rate=0.05, wd=0.01, clip_gradient=0.3)
    for src, dst in ((mt, mx), (mx, mt)):
        ctx = {"context": "cpu"} if src is mt else {}
        batches = _batches(src)
        mod = src.mod.Module(_mlp(src), **ctx)
        mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
        np.random.seed(4)
        mod.init_params(src.initializer.Xavier())
        mod.init_optimizer(optimizer=name,
                           optimizer_params=tuple(params.items()))
        for b in batches[:2]:
            mod.forward_backward(b)
            mod.update()
        prefix = str(tmp_path / ("%s_%s" % (case, src.__name__)))
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        dctx = {"context": "cpu"} if dst is mt else {}
        other = dst.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                    **dctx)
        other.bind([("data", (4, 5))], [("softmax_label", (4,))])
        other.init_optimizer(optimizer=name,
                             optimizer_params=tuple(params.items()))
        last = _batches(dst)[2]
        other.forward_backward(last)
        other.update()
        mod.forward_backward(batches[2])
        mod.update()
        want, got = mod.get_params()[0], other.get_params()[0]
        for n in want:
            np.testing.assert_allclose(got[n].asnumpy(), want[n].asnumpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=n)
