"""mxnet_tpu_torch operators against the JAX package's, forward and gradient.

Each case runs one registry op of both packages on the same numpy inputs
(``op.impl`` with the same attributes) and compares every output; where
the case names differentiable inputs, it also compares the vector-Jacobian
product for the same numpy cotangent (``jax.vjp`` against
``torch.autograd.grad``) — which checks the custom gradients of
``SoftmaxOutput`` and ``MakeLoss`` too. Tolerance rtol 1e-5 / atol 1e-6
(f32 both sides, different summation order); attention 1e-4 / 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.matrix import _infer_reshape

TOL = {"rtol": 1e-5, "atol": 1e-6}
ATT_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _f(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


def _pos(*shape):
    return lambda rng: (rng.rand(*shape) + 0.5).astype(np.float32)


def _ids(hi, *shape, lo=0):
    return lambda rng: rng.randint(lo, hi, shape).astype(np.float32)


A, B = _f(3, 4), _f(3, 4)
# name -> (op, input makers, attrs, differentiable input indices)
CASES = {}


def _case(key, op, makers, attrs=None, diff=None):
    CASES[key] = (op, makers, attrs or {},
                  list(range(len(makers))) if diff is None else diff)


for _op in ("elemwise_add", "_plus", "_minus", "_mul", "_maximum",
            "_minimum", "_hypot"):
    _case(_op, _op, [A, B])
_case("_div", "_div", [A, _pos(3, 4)])
_case("_power", "_power", [_pos(3, 4), B])
_case("_mod", "_mod", [_pos(3, 4), _pos(3, 4)], diff=[])
for _op in ("_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
            "_lesser_equal"):
    _case(_op, _op, [_ids(3, 3, 4), _ids(3, 3, 4)], diff=[])
for _op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
            "_div_scalar", "_maximum_scalar", "_minimum_scalar"):
    _case(_op, _op, [A], {"scalar": 0.3})
_case("_rdiv_scalar", "_rdiv_scalar", [_pos(3, 4)], {"scalar": 2.0})
_case("_power_scalar", "_power_scalar", [_pos(3, 4)], {"scalar": 1.5})
_case("_rpower_scalar", "_rpower_scalar", [A], {"scalar": 1.5})
_case("_greater_scalar", "_greater_scalar", [A], {"scalar": 0.1}, diff=[])
for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul",
            "broadcast_maximum"):
    _case(_op, _op, [_f(3, 4), _f(1, 4)])
_case("broadcast_div", "broadcast_div", [_f(2, 3, 4), _pos(2, 1, 4)])
_case("sum_all", "sum", [_f(2, 3, 4)])
_case("sum_axis_keep", "sum", [_f(2, 3, 4)], {"axis": 1, "keepdims": True})
_case("sum_exclude", "sum", [_f(2, 3, 4)], {"axis": (0, 2), "exclude": True})
_case("mean_axis", "mean", [_f(2, 3, 4)], {"axis": -1})
_case("max_axis", "max", [_f(2, 3, 4)], {"axis": 0})
_case("min_all", "min", [_f(2, 3, 4)])
_case("prod_axis", "prod", [_pos(2, 3, 4)], {"axis": (1, 2)})
for _i, _shape in enumerate([(0, -1), (-2,), (-3, 0), (-4, 1, -1, 0, 0),
                             (6, -1), (0, 0, -4, 2, 2)]):
    _case("reshape_%d" % _i, "Reshape", [_f(2, 3, 4)], {"shape": _shape})
_case("reshape_reverse", "Reshape", [_f(2, 3, 4)],
      {"shape": (-1, 0), "reverse": True})
_case("flatten", "Flatten", [_f(2, 3, 4)])
_case("embedding", "Embedding", [_ids(7, 2, 5), _f(7, 4)],
      {"input_dim": 7, "output_dim": 4}, diff=[1])
_case("one_hot", "one_hot", [_ids(6, 2, 3, lo=-1)],
      {"depth": 5, "on_value": 2.0, "off_value": -1.0}, diff=[])
_case("fc_flatten", "FullyConnected", [_f(3, 2, 4), _f(5, 8), _f(5)],
      {"num_hidden": 5})
_case("fc_3d_no_bias", "FullyConnected", [_f(2, 3, 4), _f(5, 4)],
      {"num_hidden": 5, "flatten": False, "no_bias": True})
for _act in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
             "silu"):
    _case("act_" + _act, "Activation", [_f(3, 7)], {"act_type": _act})
_case("softmax", "softmax", [_f(3, 7)], {"axis": -1})
_case("log_softmax_t", "log_softmax", [_f(3, 7)],
      {"axis": -1, "temperature": 2.0})
_case("layer_norm", "LayerNorm", [_f(2, 3, 8), _pos(8), _f(8)])
_case("layer_norm_axis1", "LayerNorm", [_f(2, 8, 3), _pos(8), _f(8)],
      {"axis": 1})
_case("mha_gqa_rope_causal", "MultiHeadAttention",
      [_f(2, 16, 32), _f(2, 16, 16), _f(2, 16, 16)],
      {"num_heads": 4, "num_kv_heads": 2, "causal": True, "use_rope": True})
_case("mha_full", "MultiHeadAttention",
      [_f(2, 5, 16), _f(2, 9, 16), _f(2, 9, 16)], {"num_heads": 2})
_case("softmax_output", "SoftmaxOutput", [_f(4, 6), _ids(6, 4)], diff=[0])
_case("softmax_output_ignore_valid", "SoftmaxOutput",
      [_f(4, 6), _ids(4, 4)],
      {"use_ignore": True, "ignore_label": 2, "normalization": "valid"},
      diff=[0])
_case("softmax_output_batch", "SoftmaxOutput", [_f(4, 2, 3), _ids(6, 4)],
      {"normalization": "batch", "grad_scale": 2.0}, diff=[0])
_case("softmax_output_preserve", "SoftmaxOutput", [_f(2, 3, 5),
                                                  _ids(5, 2, 3)],
      {"preserve_shape": True}, diff=[0])
_case("softmax_output_multi", "SoftmaxOutput", [_f(2, 5, 3), _ids(5, 2, 3)],
      {"multi_output": True, "use_ignore": True, "ignore_label": 0},
      diff=[0])
_case("make_loss", "MakeLoss", [_f(3, 4)], {"grad_scale": 0.5})
_case("make_loss_batch", "MakeLoss", [_f(3, 4)], {"normalization": "batch"})
_case("make_loss_valid", "MakeLoss", [_f(3, 4)],
      {"normalization": "valid", "valid_thresh": 0.1})
_case("sgd_update", "sgd_update", [_f(3, 4), _f(3, 4)],
      {"lr": 0.1, "wd": 0.01, "rescale_grad": 2.0, "clip_gradient": 0.5},
      diff=[])
_case("sgd_mom_update", "sgd_mom_update", [_f(3, 4), _f(3, 4), _f(3, 4)],
      {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, diff=[])
_case("adam_update", "adam_update",
      [_f(3, 4), _f(3, 4), _f(3, 4), _pos(3, 4)],
      {"lr": 0.01, "wd": 0.01, "clip_gradient": 0.5}, diff=[])


def _jax_run(op, arrays, attrs, diff, cot_seed):
    jop = jreg.get_op(op)
    parsed = jop.parse_attrs(dict(attrs))
    xs = [jnp.asarray(a) for a in arrays]

    def f(*dx):
        ins = list(xs)
        for i, x in zip(diff, dx):
            ins[i] = x
        outs, _ = jop.impl(parsed, tuple(ins), (),
                           jreg.OpContext(True, None))
        return outs

    outs = f(*[xs[i] for i in diff])
    if not diff:
        return [np.asarray(o) for o in outs], []
    cot = np.asarray(np.random.RandomState(cot_seed).randn(
        *outs[0].shape), np.float32)
    _, vjp = jax.vjp(lambda *dx: f(*dx)[0], *[xs[i] for i in diff])
    return [np.asarray(o) for o in outs], \
        [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_run(op, arrays, attrs, diff, cot_seed):
    top = treg.get_op(op)
    parsed = top.parse_attrs(dict(attrs))
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    outs, _ = top.impl(parsed, tuple(xs), (), treg.OpContext(True))
    got = [o.detach().numpy().copy() for o in outs]
    if not diff:
        return got, []
    cot = np.asarray(np.random.RandomState(cot_seed).randn(
        *outs[0].shape), np.float32)
    grads = torch.autograd.grad(outs[0], [xs[i] for i in diff],
                                torch.from_numpy(cot))
    return got, [g.numpy() for g in grads]


@pytest.mark.parametrize("key", sorted(CASES))
def test_op_matches_jax(key):
    op, makers, attrs, diff = CASES[key]
    rng = np.random.RandomState(len(key))
    arrays = [m(rng) for m in makers]
    want_out, want_grad = _jax_run(op, arrays, attrs, diff, 7)
    got_out, got_grad = _torch_run(op, arrays, attrs, diff, 7)
    tol = ATT_TOL if op == "MultiHeadAttention" else TOL
    assert len(got_out) == len(want_out)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **tol)
    for i, g, w in zip(diff, got_grad, want_grad):
        np.testing.assert_allclose(g, w, err_msg="grad of input %d" % i,
                                   **tol)


@pytest.mark.parametrize("shape,target,reverse", [
    ((2, 3, 4), (0, -1), False), ((2, 3, 4), (-4, 1, 2, -2), False),
    ((2, 3, 4, 5), (-3, -3), False), ((2, 3, 4), (-1, 0), True),
    ((10, 5, 4), (-1, 0), True)])
def test_reshape_codes_match_jax(shape, target, reverse):
    from mxnet_tpu.ops.matrix import _infer_reshape as jinfer

    if reverse:
        assert (_infer_reshape(shape[::-1], target[::-1])[::-1]
                == jinfer(shape[::-1], target[::-1])[::-1])
    else:
        assert _infer_reshape(shape, target) == jinfer(shape, target)


def test_nd_namespace_runs_ops_with_out_and_arithmetic():
    a = nd.array([[1.0, 2.0], [3.0, 4.0]], ctx="cpu")
    b = nd.ones((2, 2), ctx="cpu")
    assert a.dtype == np.float32 and a.context == torch.device("cpu")
    np.testing.assert_array_equal((a + b * 2 - 1).asnumpy(),
                                  [[2, 3], [4, 5]])
    np.testing.assert_array_equal((1 - a).asnumpy(), [[0, -1], [-2, -3]])
    out = nd.zeros((2, 2), ctx="cpu")
    res = nd.elemwise_add(a, b, out=out)
    assert res is out and out.asnumpy()[1, 1] == 5
    assert float(nd.sum(a).asscalar()) == 10.0
    assert a.sum(axis=0).shape == (2,)
    a += 1
    a[0] = 0.0
    np.testing.assert_array_equal(a.asnumpy(), [[0, 0], [4, 5]])
    c = a.copy()
    c[:] = 7
    assert a.asnumpy()[1, 1] == 5 and (c.asnumpy() == 7).all()
    c.copyto(a)
    assert (a.asnumpy() == 7).all()
    assert nd.full((3,), 2.5, ctx="cpu").asnumpy().tolist() == [2.5] * 3
    assert nd.array(np.arange(3), ctx="cpu").dtype == np.int64
    assert nd.array([1, 2], ctx="cpu", dtype="bfloat16").dtype == \
        torch.bfloat16
