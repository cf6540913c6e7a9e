"""The core operators of the port's second op slice against the JAX
package's: the unary families, ``Cast`` and ``add_n`` of ``elemwise``, the
index reductions, ``pick`` and the logical broadcasts of
``broadcast_reduce``, the shape, indexing and ordering ops of ``matrix``,
``RMSNorm``, and the layer heads, norms and spatial ops of ``nn``.

Each case of ``mxnet_tpu_torch/tools/op_cases.py``'s table (the one that
``chip_smoke.py`` runs on the card at full shapes) runs here at its small
shapes: one registry op of both packages on the same seeded numpy inputs,
every output and, where the case names differentiable inputs, the
vector-Jacobian product compared (``test_torch_ops.py``'s harness).
Tolerance rtol 1e-5 / atol 1e-6 (f32 both sides, libm and summation order
differ); the outputs bit for bit for the ops that only move, pick, order
or round values. Ties are integer-valued inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.tools.op_cases import CONTRIB_OPS, exact_output, \
    op_cases
from test_torch_ops import _jax_run, _torch_run

TOL = {"rtol": 1e-5, "atol": 1e-6}
EXACT = {"rtol": 0, "atol": 0}

# the 87 names of the JAX package's registry this slice adds (every one
# but the nine contrib.py ops of ssd's slice); each is a case below or has
# a test of its own
NEW_OPS = (
    "_hypot_scalar", "rint", "round", "ceil", "floor", "trunc", "fix",
    "rsqrt", "cbrt", "rcbrt", "log10", "log2", "log1p", "expm1", "sin",
    "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
    "arcsinh", "arccosh", "arctanh", "degrees", "radians", "gamma",
    "gammaln", "reciprocal", "sigmoid", "softsign", "erf", "erfinv",
    "logical_not", "make_loss", "Cast", "smooth_l1", "add_n",
    "ElementWiseSum", "_sum", "argmax", "argmin", "argmax_channel", "pick",
    "nansum", "nanprod", "broadcast_axis", "broadcast_axes",
    "broadcast_hypot", "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "batch_dot", "transpose", "slice", "crop",
    "tile", "repeat", "reverse", "flip", "Pad", "pad", "take",
    "batch_take", "sort", "argsort", "topk", "RMSNorm", "LeakyReLU",
    "InstanceNorm", "L2Normalization", "LRN", "SoftmaxActivation",
    "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "SVMOutput", "IdentityAttachKLSparseReg",
    "Deconvolution", "UpSampling", "GridGenerator", "BilinearSampler",
    "SpatialTransformer", "ROIPooling", "Crop")
# the nine contrib.py ops of ssd's slice (each a case of the table too)
CONTRIB = CONTRIB_OPS

# the table's cases at their small shapes, but Cast's (a bfloat16 output
# has no numpy type; test_cast_matches_jax), those with aux states
# (test_identity_attach_kl_sparse_reg_matches_jax) and the contrib ops'
# (tests/test_torch_detection.py)
CASES = {key: c for key, c in op_cases().items()
         if c.op != "Cast" and not c.aux and c.op not in CONTRIB_OPS}


@pytest.mark.parametrize("key", sorted(CASES))
def test_op_matches_jax(key):
    op, makers, attrs, diff, exact, _ = CASES[key]
    rng = np.random.RandomState(len(key))
    arrays = [m(rng) for m in makers]
    want_out, want_grad = _jax_run(op, arrays, attrs, diff, 7)
    got_out, got_grad = _torch_run(op, arrays, attrs, diff, 7)
    assert len(got_out) == len(want_out)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        tol = EXACT if exact_output(CASES[key], i) else TOL
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **tol)
    for i, g, w in zip(diff, got_grad, want_grad):
        np.testing.assert_allclose(g, w, err_msg="grad of input %d" % i,
                                   **TOL)


def test_every_new_op_is_registered_and_has_a_case():
    """The port registers every op of the JAX package's registry (the 87
    of the core slice and the nine contrib ops of ssd's), nothing else,
    and each of those names is a case here (Cast and
    IdentityAttachKLSparseReg have tests of their own)."""
    assert len(NEW_OPS) == 87 == len(set(NEW_OPS))
    assert len(CONTRIB) == 9 and not set(CONTRIB) & set(NEW_OPS)
    assert set(jreg.OP_REGISTRY) == set(treg.OP_REGISTRY)
    assert len(treg.OP_REGISTRY) == 234
    covered = {c.op for c in CASES.values()}
    assert set(NEW_OPS) - covered == {"Cast", "IdentityAttachKLSparseReg"}
    assert {c.op for c in op_cases().values()} == set(NEW_OPS) | set(CONTRIB)


@pytest.mark.parametrize("dtype", ["float16", "float64", "bfloat16",
                                   "int32", "uint8", "int64"])
def test_cast_matches_jax(dtype):
    """Cast to the float types, bfloat16 and the integer types (toward
    zero), exactly. The JAX package runs without 64-bit types (its
    float64 / int64 casts land on 32 bits); the port keeps 64 bits."""
    x = (np.random.RandomState(3).randn(3, 5) * 40).astype(np.float32)
    if dtype == "uint8":
        x = np.abs(x)
    attrs = {"dtype": dtype}
    (want,), _ = jreg.get_op("Cast").impl(
        jreg.get_op("Cast").parse_attrs(attrs), (jnp.asarray(x),), (),
        jreg.OpContext(False, None))
    top = treg.get_op("Cast")
    (got,), _ = top.impl(top.parse_attrs(attrs), (torch.from_numpy(x),),
                         (), treg.OpContext(False))
    assert str(got.dtype) == "torch." + (
        dtype if dtype.endswith("64") else str(want.dtype))
    np.testing.assert_array_equal(got.float().numpy() if dtype == "bfloat16"
                                  else got.numpy().astype(want.dtype),
                                  np.asarray(want, np.float32)
                                  if dtype == "bfloat16" else want)


@pytest.mark.parametrize("is_train", [True, False])
def test_identity_attach_kl_sparse_reg_matches_jax(is_train):
    """Identity forward; ``moving_avg`` moves only in training; the
    backward adds the penalty from this batch's mean activation, not from
    ``moving_avg``."""
    import jax

    rng = np.random.RandomState(5)
    x = rng.uniform(0.05, 0.6, (4, 6)).astype(np.float32)
    moving = rng.uniform(0.1, 0.3, 6).astype(np.float32)
    cot = rng.randn(4, 6).astype(np.float32)
    attrs = {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.8}
    jop = jreg.get_op("IdentityAttachKLSparseReg")
    parsed = jop.parse_attrs(attrs)

    def jf(d):
        outs, aux = jop.impl(parsed, (d,), (jnp.asarray(moving),),
                             jreg.OpContext(is_train, None))
        return outs[0], aux[0]

    (want, want_aux), vjp = jax.vjp(jf, jnp.asarray(x))
    (want_grad,) = vjp((jnp.asarray(cot), jnp.zeros(6, jnp.float32)))
    top = treg.get_op("IdentityAttachKLSparseReg")
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (out,), (aux,) = top.impl(top.parse_attrs(attrs), (xt,),
                              (torch.from_numpy(moving.copy()),),
                              treg.OpContext(is_train))
    (grad,) = torch.autograd.grad(out, [xt], torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), x)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    if not is_train:
        np.testing.assert_array_equal(aux.numpy(), moving)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)
    assert not np.allclose(grad.numpy(), cot)


def test_new_ops_in_the_nd_and_sym_namespaces():
    """The generated namespaces carry the new ops: nd.topk / nd.Cast run
    imperatively; a symbol of Deconvolution / prelu / bilinear UpSampling
    infers its parameters' shapes as the JAX package's does."""
    import mxnet_tpu as mx

    x = nd.array([[3.0, 1.0, 3.0, 2.0]], ctx="cpu")
    np.testing.assert_array_equal(nd.topk(x, k=2).asnumpy(), [[0.0, 2.0]])
    assert nd.Cast(x, dtype="int32").dtype == np.int32
    np.testing.assert_array_equal(nd.ElementWiseSum(x, x, x).asnumpy(),
                                  3 * x.asnumpy())
    for pkg in (sym, mx.sym):
        data = pkg.Variable("data")
        net = pkg.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                                num_filter=6, num_group=2, no_bias=False,
                                name="de")
        net = pkg.LeakyReLU(net, act_type="prelu", name="pr")
        w = pkg.Variable("up_weight")
        net = pkg.UpSampling(net, w, scale=2, sample_type="bilinear",
                             num_args=2, name="up")
        net = pkg.IdentityAttachKLSparseReg(pkg.Flatten(net), name="kl")
        args, outs, aux = net.infer_shape(data=(2, 4, 5, 5))
        if pkg is sym:
            got = (net.list_arguments(), args, outs,
                   net.list_auxiliary_states(), aux)
        else:
            assert got == (net.list_arguments(), args, outs,
                           net.list_auxiliary_states(), aux)
    assert dict(zip(got[0], got[1]))["up_weight"] == (6, 1, 4, 4)


# the inputs of the saturation finding: below, far above and at the edges
# of every integer type's range, NaN and the infinities
SATURATE = np.array([-3.7, 1e10, np.nan, np.inf, -np.inf, 70000.0,
                     2147483520.0, 2147483648.0, -2147483648.0, -3e9,
                     255.9, 256.0, -0.9, -128.5, 127.99, 32768.0, -40000.0],
                    np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32", "int64"])
def test_cast_saturates_out_of_range_as_jax(dtype):
    """A float cast to an integer type truncates toward zero, saturates
    at the type's bounds and sends NaN to 0, exactly as the JAX package's
    ``Cast`` and ``astype``; int64 keeps 64 bits and saturates in its own
    range (the JAX package, without 64-bit types, lands on int32's)."""
    import mxnet_tpu as mx

    jop = jreg.get_op("Cast")
    (want,), _ = jop.impl(jop.parse_attrs({"dtype": dtype}),
                          (jnp.asarray(SATURATE),), (),
                          jreg.OpContext(False, None))
    want = np.asarray(want)
    top = treg.get_op("Cast")
    (got,), _ = top.impl(top.parse_attrs({"dtype": dtype}),
                         (torch.from_numpy(SATURATE.copy()),), (),
                         treg.OpContext(False))
    got_nd = nd.array(SATURATE, ctx="cpu").astype(dtype).asnumpy()
    if dtype == "int64":
        # every finite input lies inside int64: only the infinities
        # saturate, NaN goes to 0
        info = np.iinfo(np.int64)
        want = np.trunc(np.nan_to_num(SATURATE, nan=0.0, posinf=0.0,
                                      neginf=0.0)).astype(np.int64)
        want[np.isposinf(SATURATE)] = info.max
        want[np.isneginf(SATURATE)] = info.min
        assert got.dtype == torch.int64
    else:
        np.testing.assert_array_equal(
            mx.nd.array(SATURATE).astype(dtype).asnumpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_nd, want)
    assert got_nd.dtype == np.dtype(dtype)


def test_abs_gradient_at_zero_matches_jax():
    """``abs``'s gradient at +0 and -0 is the cotangent, as
    ``jax.grad(jnp.abs)``'s; elsewhere its sign times the cotangent."""
    x = np.array([0.0, -0.0, 1.5, -2.0], np.float32)
    cot = np.array([1.6905, -0.5, 2.0, 3.0], np.float32)
    want_out, want_grad = _jax_vjp("abs", x, cot)
    got_out, got_grad = _torch_vjp("abs", x, cot)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_grad, want_grad)
    np.testing.assert_array_equal(got_grad[:2], cot[:2])


def _jax_vjp(op, x, cot):
    import jax

    jop = jreg.get_op(op)
    parsed = jop.parse_attrs({})
    out, vjp = jax.vjp(lambda v: jop.impl(parsed, (v,), (), jreg.OpContext(
        True, None))[0][0], jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_vjp(op, x, cot):
    top = treg.get_op(op)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (out,), _ = top.impl(top.parse_attrs({}), (xt,), (),
                         treg.OpContext(True))
    (grad,) = torch.autograd.grad(out, [xt], torch.from_numpy(cot))
    return out.detach().numpy(), grad.numpy()


def _same_class(got, want):
    """Both NaN, or both infinite of one sign, or equal with one sign bit
    (-0 is not +0)."""
    return all((np.isnan(g) and np.isnan(w)) or
               (g == w and np.signbit(g) == np.signbit(w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("op", ["cbrt", "rcbrt", "gamma", "gammaln"])
def test_unary_gradients_at_their_poles_match_jax(op):
    """At 0 and -0 each output and gradient has the JAX package's value,
    class and sign (asked of JAX, not written down): cbrt(-0) is -0,
    cbrt's gradient +inf, rcbrt's -inf, gamma's and gammaln's NaN. Away
    from the pole the usual tolerance."""
    x = np.array([0.0, -0.0], np.float32)
    cot = np.array([1.25, 0.75], np.float32)
    want_out, want_grad = _jax_vjp(op, x, cot)
    got_out, got_grad = _torch_vjp(op, x, cot)
    assert _same_class(got_out, want_out), (got_out, want_out)
    assert _same_class(got_grad, want_grad), (got_grad, want_grad)
    away = np.array([0.3, -1.7, 2.5, 8.0], np.float32)
    if op in ("gamma", "gammaln"):
        away = np.abs(away)
    cot = np.array([0.5, 1.0, -1.0, 2.0], np.float32)
    want_out, want_grad = _jax_vjp(op, away, cot)
    got_out, got_grad = _torch_vjp(op, away, cot)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    np.testing.assert_allclose(got_grad, want_grad, **TOL)
