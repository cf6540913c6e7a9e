"""The port's new initializers, metrics, callback and ops against the JAX
package's, on the CPU.

- Orthogonal (uniform and normal), MSRAPrelu, Bilinear, Mixed and Load
  fill the same arrays bit for bit under one ``np.random`` seed (both draw
  from numpy), and the name dispatch sends ``*upsampling`` to the
  bilinear kernel and ``*moving_inv_var`` / ``*moving_avg`` to 0.
- F1, MAE, MSE, RMSE, Torch and Caffe give the JAX package's values on
  the same seeded labels and predictions (the same host arithmetic:
  equal, to 1e-12 for the sums), by class and by name.
- ``LogValidationMetricsCallback`` logs the same lines.
- ``clip``, ``sign``, ``moveaxis`` and ``onehot_encode`` equal the JAX
  package's bit for bit; ``norm`` within 1e-6 relative (sums in another
  order).
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

INITS = {
    "orthogonal": (lambda p: p.initializer.Orthogonal(), "fc_weight",
                   (12, 7)),
    "orthogonal_wide": (lambda p: p.initializer.Orthogonal(scale=0.5),
                        "fc_weight", (5, 3, 2, 2)),
    "orthogonal_normal": (lambda p: p.initializer.Orthogonal(
        rand_type="normal"), "conv_weight", (6, 2, 3, 3)),
    "msraprelu": (lambda p: p.initializer.MSRAPrelu(), "conv_weight",
                  (8, 4, 3, 3)),
    "msraprelu_in": (lambda p: p.initializer.MSRAPrelu(factor_type="in",
                                                       slope=0.1),
                     "fc_weight", (9, 13)),
    "bilinear": (lambda p: p.initializer.Bilinear(), "deconv_weight",
                 (3, 1, 4, 4)),
    "bilinear_odd": (lambda p: p.initializer.Bilinear(), "deconv_weight",
                     (2, 2, 5, 5)),
    "upsampling_dispatch": (lambda p: p.initializer.Uniform(),
                            "up_upsampling", (2, 1, 6, 6)),
    "moving_inv_var": (lambda p: p.initializer.Uniform(),
                       "bn_moving_inv_var", (5,)),
    "mixed": (lambda p: p.initializer.Mixed(
        [".*bias", ".*"], [p.initializer.Constant(0.3),
                           p.initializer.Normal(0.5)]), "fc_weight",
              (4, 6)),
    "mixed_bias": (lambda p: p.initializer.Mixed(
        [".*bias", ".*"], [p.initializer.Constant(0.3),
                           p.initializer.Normal(0.5)]), "fc_bias", (4,)),
}


def _fill(pkg, make, name, shape, seed=3):
    arr = pkg.nd.zeros(shape, ctx="cpu") if pkg is mt else pkg.nd.zeros(
        shape)
    np.random.seed(seed)
    make(pkg)(pkg.initializer.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("case", sorted(INITS))
def test_initializer_equals_the_jax_package_bit_for_bit(case):
    make, name, shape = INITS[case]
    got, want = _fill(mt, make, name, shape), _fill(mx, make, name, shape)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # a bias and a moving_inv_var are 0 whatever the initializer
    assert (np.abs(got).max() > 0) == (case not in ("moving_inv_var",
                                                    "mixed_bias"))


def test_orthogonal_rows_are_orthogonal_and_registered_by_name():
    w = _fill(mt, INITS["orthogonal"][0], "fc_weight", (12, 7))
    np.testing.assert_allclose(w.T @ w / 1.414 ** 2, np.eye(7), atol=1e-5)
    for name in ("orthogonal", "msraprelu", "bilinear"):
        assert name in mt.init_registry and name in mx.init_registry
        assert mt.initializer.create(name).__class__.__name__.lower() == name
    assert mt.initializer.MSRAPrelu(slope=0.5).dumps() == \
        mx.initializer.MSRAPrelu(slope=0.5).dumps()


def test_load_reads_the_jax_packages_file_and_falls_back(tmp_path):
    rng = np.random.RandomState(0)
    w, b = rng.rand(4, 3).astype(np.float32), rng.rand(4).astype(np.float32)
    fname = str(tmp_path / "p.params")
    mx.nd.save(fname, {"arg:fc_weight": mx.nd.array(w),
                       "aux:fc_bias": mx.nd.array(b)})
    loads = {mt: mt.initializer.Load(fname, mt.initializer.Constant(7.0)),
             mx: mx.initializer.Load(fname, mx.initializer.Constant(7.0))}
    for name, shape, want in (("fc_weight", (4, 3), w), ("fc_bias", (4,), b),
                              ("other_weight", (2, 2),
                               np.full((2, 2), 7.0, np.float32))):
        for pkg, init in loads.items():
            arr = pkg.nd.zeros(shape, ctx="cpu") if pkg is mt else \
                pkg.nd.zeros(shape)
            init(pkg.initializer.InitDesc(name), arr)
            assert np.array_equal(arr.asnumpy(), want), (pkg, name)
    with pytest.raises(ValueError, match="shape mismatch"):
        loads[mt]("fc_weight", mt.nd.zeros((3, 4), ctx="cpu"))
    with pytest.raises(ValueError, match="not found and no default"):
        mt.initializer.Load(fname)("other", mt.nd.zeros((1,), ctx="cpu"))
    with pytest.raises(ValueError, match="did not match"):
        mt.initializer.Mixed(["a.*"], [mt.initializer.Zero()])(
            "b", mt.nd.zeros((1,), ctx="cpu"))


def _metric_inputs(seed=1):
    rng = np.random.RandomState(seed)
    cls = [(rng.randint(0, 2, 30).astype(np.float32),
            rng.uniform(0, 1, (30, 2)).astype(np.float32)) for _ in range(3)]
    reg = [(rng.uniform(-1, 1, 30).astype(np.float32),
            rng.uniform(-1, 1, (30, 1)).astype(np.float32)),
           (rng.uniform(-1, 1, (30, 2)).astype(np.float32),
            rng.uniform(-1, 1, (30, 2)).astype(np.float32))]
    return cls, reg


@pytest.mark.parametrize("name", ["F1", "MAE", "MSE", "RMSE", "Torch",
                                  "Caffe"])
def test_metric_equals_the_jax_package(name):
    cls, reg = _metric_inputs()
    data = cls if name == "F1" else reg
    out = {}
    for pkg, ctx in ((mt, "cpu"), (mx, None)):
        kw = {"ctx": ctx} if ctx else {}
        for m in (getattr(pkg.metric, name)(),
                  pkg.metric.create(name.lower())
                  if name not in ("Torch", "Caffe") else None):
            if m is None:
                continue
            for lab, pred in data:
                m.update([pkg.nd.array(lab, **kw)],
                         [pkg.nd.array(pred, **kw)])
            out.setdefault(pkg, []).append(m.get())
    for (gn, gv), (wn, wv) in zip(out[mt], out[mx]):
        assert gn == wn
        np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=0)


def test_f1_refuses_more_than_two_classes_as_the_jax_package():
    lab = np.array([0, 1, 2], np.float32)
    pred = np.eye(3, dtype=np.float32)
    for pkg, kw in ((mt, {"ctx": "cpu"}), (mx, {})):
        with pytest.raises(ValueError, match="binary"):
            pkg.metric.F1().update([pkg.nd.array(lab, **kw)],
                                   [pkg.nd.array(pred, **kw)])


def test_log_validation_metrics_callback_logs_as_the_jax_package(caplog):
    lines = {}
    for pkg, kw in ((mt, {"ctx": "cpu"}), (mx, {})):
        m = pkg.metric.create(["mae", "rmse"])
        lab, pred = _metric_inputs()[1][0]
        m.update([pkg.nd.array(lab, **kw)], [pkg.nd.array(pred, **kw)])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pkg.callback.LogValidationMetricsCallback()(
                pkg.model.BatchEndParam(epoch=3, nbatch=0, eval_metric=m,
                                        locals=None))
            pkg.callback.LogValidationMetricsCallback()(
                pkg.model.BatchEndParam(epoch=3, nbatch=0, eval_metric=None,
                                        locals=None))
        lines[pkg] = [r.getMessage() for r in caplog.records]
    assert lines[mt] == lines[mx] and len(lines[mt]) == 2
    assert lines[mt][0].startswith("Epoch[3] Validation-mae=")


def _x(seed=2, shape=(5, 6, 7)):
    return np.random.RandomState(seed).uniform(-2, 2, shape).astype(
        np.float32)


@pytest.mark.parametrize("op,attrs", [
    ("clip", {"a_min": -0.5, "a_max": 1.25}),
    ("clip", {}),
    ("sign", {}),
])
def test_elementwise_ops_equal_the_jax_package(op, attrs):
    x = _x()
    x[0, 0, :3] = 0.0
    got = getattr(mt.nd, op)(mt.nd.array(x, ctx="cpu"), **attrs).asnumpy()
    want = getattr(mx.nd, op)(mx.nd.array(x), **attrs).asnumpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ord_", [1, 2])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, False),
                                           ((0, 2), True), (-1, True)])
def test_norm_equals_the_jax_package(ord_, axis, keepdims):
    x = _x(3)
    got = mt.nd.norm(mt.nd.array(x, ctx="cpu"), ord=ord_, axis=axis,
                     keepdims=keepdims).asnumpy()
    want = mx.nd.norm(mx.nd.array(x), ord=ord_, axis=axis,
                      keepdims=keepdims).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_moveaxis_and_onehot_encode_equal_the_jax_package():
    x = _x(4)
    for src, dst in ((0, 2), (-1, 0), (1, 1)):
        got = mt.nd.moveaxis(mt.nd.array(x, ctx="cpu"), src, dst).asnumpy()
        want = mx.nd.moveaxis(mx.nd.array(x), src, dst).asnumpy()
        assert np.array_equal(got, want)
    ids = np.array([0, 3, 1, 4, 4, 2], np.float32)
    out_t = mt.nd.zeros((6, 5), ctx="cpu")
    res = mt.nd.onehot_encode(mt.nd.array(ids, ctx="cpu"), out_t)
    out_j = mx.nd.zeros((6, 5))
    mx.nd.onehot_encode(mx.nd.array(ids), out_j)
    assert res is out_t
    assert np.array_equal(out_t.asnumpy(), out_j.asnumpy())


def test_clip_takes_its_bounds_by_keyword_only_as_the_jax_package():
    x = _x(5)
    with pytest.raises(Exception):
        mt.nd.clip(mt.nd.array(x, ctx="cpu"), -0.5, 0.5)
    with pytest.raises(Exception):
        mx.nd.clip(mx.nd.array(x), -0.5, 0.5)
    s = mt.sym.clip(mt.sym.Variable("x"), a_min=0.0, a_max=0.5)
    exe = s.simple_bind(ctx="cpu", x=x.shape)
    exe.forward(x=mt.nd.array(x, ctx="cpu"))
    assert np.array_equal(exe.outputs[0].asnumpy(), np.clip(x, 0.0, 0.5))
