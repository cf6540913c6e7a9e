"""Elementwise binary, binary-with-scalar and unary operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` (reference
elemwise_binary_op_basic.cc, elemwise_binary_scalar_op*.cc,
elemwise_unary_op.cc and the SimpleOp unary math ops), with ``Cast``,
``smooth_l1`` and the variadic ``add_n``. Gradients come from autograd
over the composed graph. Comparison and logical ops return 0/1 in the
input's type, like the reference.

Where the JAX package and MXNet 0.9 differ, the port follows the JAX
package: ``round`` and ``rint`` round half to even, and ``gamma`` is
``exp(lgamma(x))``, which drops the sign of Gamma at negative
non-integers.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import alias, defop


def _binary(name, fn):
    defop(name, arg_names=("lhs", "rhs"), param_spec={})(
        lambda attrs, lhs, rhs, _f=fn: _f(lhs, rhs))


def _binary_scalar(name, fn):
    defop(name, arg_names=("data",), param_spec={"scalar": 0.0})(
        lambda attrs, data, _f=fn: _f(data, float(attrs["scalar"])))


def _unary(name, fn):
    defop(name, arg_names=("data",), param_spec={})(
        lambda attrs, data, _f=fn: _f(data))


def _cmp(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


# --- binary (reference elemwise_binary_op_basic.cc) --------------------------
for _n in ("elemwise_add", "_plus"):
    _binary(_n, torch.add)
for _n in ("elemwise_sub", "_minus"):
    _binary(_n, torch.sub)
for _n in ("elemwise_mul", "_mul"):
    _binary(_n, torch.mul)
for _n in ("elemwise_div", "_div"):
    _binary(_n, torch.div)
_binary("_mod", torch.remainder)
_binary("_power", torch.pow)
_binary("_maximum", torch.maximum)
_binary("_minimum", torch.minimum)
_binary("_hypot", torch.hypot)
_binary("_equal", _cmp(torch.eq))
_binary("_not_equal", _cmp(torch.ne))
_binary("_greater", _cmp(torch.gt))
_binary("_greater_equal", _cmp(torch.ge))
_binary("_lesser", _cmp(torch.lt))
_binary("_lesser_equal", _cmp(torch.le))

# --- binary with scalar (reference elemwise_binary_scalar_op*.cc) ------------
_binary_scalar("_plus_scalar", lambda x, s: x + s)
_binary_scalar("_minus_scalar", lambda x, s: x - s)
_binary_scalar("_rminus_scalar", lambda x, s: s - x)
_binary_scalar("_mul_scalar", lambda x, s: x * s)
_binary_scalar("_div_scalar", lambda x, s: x / s)
_binary_scalar("_rdiv_scalar", lambda x, s: s / x)
_binary_scalar("_mod_scalar", torch.remainder)
_binary_scalar("_rmod_scalar", lambda x, s: torch.remainder(
    torch.full_like(x, s), x))
_binary_scalar("_power_scalar", torch.pow)
_binary_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
_binary_scalar("_maximum_scalar", lambda x, s: x.clamp(min=s))
_binary_scalar("_minimum_scalar", lambda x, s: x.clamp(max=s))
_binary_scalar("_hypot_scalar", lambda x, s: torch.hypot(x, x.new_tensor(s)))
_binary_scalar("_equal_scalar", _cmp(torch.eq))
_binary_scalar("_not_equal_scalar", _cmp(torch.ne))
_binary_scalar("_greater_scalar", _cmp(torch.gt))
_binary_scalar("_greater_equal_scalar", _cmp(torch.ge))
_binary_scalar("_lesser_scalar", _cmp(torch.lt))
_binary_scalar("_lesser_equal_scalar", _cmp(torch.le))

# --- unary (reference elemwise_unary_op.cc + the SimpleOp registry) ---------
class _Abs(torch.autograd.Function):
    """|x| with ``jax.grad(jnp.abs)``'s gradient: g where x >= 0 (at -0
    too), -g elsewhere (NaN included); ``torch.abs`` gives 0 at 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


class _Cbrt(torch.autograd.Function):
    """The real cube root, negative below 0 and -0 at -0 (``jnp.cbrt``;
    PyTorch has none, and ``x ** (1 / 3)`` is NaN below 0), with JAX's
    gradient g / (3 cbrt(x)^2): +inf at both zeros."""

    @staticmethod
    def forward(ctx, x):
        y = torch.copysign(x.abs().pow(1.0 / 3.0), x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * ((1.0 / 3.0) * (1.0 / (y * y)))


class _Lgamma(torch.autograd.Function):
    """log|Gamma(x)| with JAX's gradient, digamma(x), which is NaN at both
    zeros (``torch.digamma`` gives -inf at 0 and +inf at -0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = torch.digamma(x)
        return g * torch.where(x == 0, torch.full_like(d, float("nan")), d)


def abs_(x):
    """|x| with the JAX package's gradient at 0 (:class:`_Abs`)."""
    return _Abs.apply(x)


def _cbrt(x):
    return _Cbrt.apply(x)


def _lgamma(x):
    return _Lgamma.apply(x)


for _n, _fn in (
        ("negative", torch.neg), ("abs", abs_), ("sign", torch.sign),
        ("rint", torch.round), ("round", torch.round), ("ceil", torch.ceil),
        ("floor", torch.floor), ("trunc", torch.trunc), ("fix", torch.trunc),
        ("square", torch.square), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("cbrt", _cbrt),
        ("rcbrt", lambda x: 1.0 / _cbrt(x)),
        ("exp", torch.exp), ("log", torch.log), ("log10", torch.log10),
        ("log2", torch.log2), ("log1p", torch.log1p), ("expm1", torch.expm1),
        ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
        ("arcsin", torch.asin), ("arccos", torch.acos),
        ("arctan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("tanh", torch.tanh), ("arcsinh", torch.asinh),
        ("arccosh", torch.acosh), ("arctanh", torch.atanh),
        ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
        ("gamma", lambda x: torch.exp(_lgamma(x))),
        ("gammaln", _lgamma), ("reciprocal", lambda x: 1.0 / x),
        ("relu", torch.relu), ("sigmoid", torch.sigmoid),
        ("softsign", lambda x: x / (1.0 + x.abs())), ("erf", torch.erf),
        ("erfinv", torch.erfinv),
        ("logical_not", lambda x: (x == 0).to(x.dtype)),
        ("_copy", lambda x: x.clone()), ("BlockGrad", lambda x: x.detach()),
        # a plain identity, gradient and all (not MakeLoss)
        ("make_loss", lambda x: x.clone())):
    _unary(_n, _fn)


def torch_dtype(name):
    """The torch dtype of a numpy type name, ``"bfloat16"`` included."""
    if name == "bfloat16":
        return torch.bfloat16
    return getattr(torch, str(np.dtype(name)))


def saturating_cast(data, dtype):
    """``data`` in ``dtype`` as the JAX package converts it: a float to an
    integer type truncates toward zero, saturates at the type's bounds and
    sends NaN to 0; every other conversion is ``Tensor.to``'s. The bounds
    are compared as floats (2^31 is one; 2^31 - 1 is not an f32), every
    out-of-range value is replaced before the conversion (what a device
    does with one is its own), and the integer bound selected after."""
    if not data.is_floating_point() or dtype.is_floating_point \
            or dtype == torch.bool:
        return data.to(dtype)
    info = torch.iinfo(dtype)
    t = torch.trunc(data)
    high = t >= float(info.max) + 1.0      # a power of two: exact
    low = t < float(info.min)
    out = torch.where(high | low | torch.isnan(t), torch.zeros_like(t),
                      t).to(dtype)
    out = torch.where(high, torch.full_like(out, info.max), out)
    return torch.where(low, torch.full_like(out, info.min), out)


@defop("Cast", arg_names=("data",), param_spec={"dtype": "float32"})
def _cast(attrs, data):
    """Cast to ``dtype`` (reference elemwise_unary_op.cc Cast): the float
    types, bfloat16 and the integer types (:func:`saturating_cast`)."""
    return saturating_cast(data, torch_dtype(attrs["dtype"]))


@defop("smooth_l1", arg_names=("data",), param_spec={"scalar": 1.0})
def _smooth_l1(attrs, data):
    """Smooth L1 (Huber) with sigma = ``scalar``: 0.5 (sigma x)^2 where
    |x| < 1 / sigma^2, else |x| - 0.5 / sigma^2 (reference
    elemwise_binary_scalar_op_extended.cc smooth_l1)."""
    s2 = float(attrs["scalar"]) ** 2
    absx = data.abs()
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * data * data,
                       absx - 0.5 / s2)


@defop("add_n", arg_names=(), variadic=True, param_spec={"num_args": 0})
def _add_n(attrs, *inputs):
    """The inputs' sum, added left to right (reference elemwise_sum.cc
    ElementWiseSum)."""
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return out


@defop("clip", arg_names=("data",), param_spec={"a_min": 0.0, "a_max": 1.0})
def _clip(attrs, data):
    """Clip to [a_min, a_max] (reference matrix_op.cc clip); the bounds
    are attributes, so ``nd.clip`` takes them by keyword only, as the JAX
    package's does."""
    return data.clamp(float(attrs["a_min"]), float(attrs["a_max"]))


alias("_copy", "identity")
alias("BlockGrad", "stop_gradient")
alias("add_n", "ElementWiseSum", "_sum")
