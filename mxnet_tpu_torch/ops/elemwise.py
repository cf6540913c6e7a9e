"""Elementwise binary and binary-with-scalar operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py``'s ``_binary`` and
``_binary_scalar`` families (reference elemwise_binary_op_basic.cc,
elemwise_binary_scalar_op*.cc), plus the few unary ops the ported paths
use. Gradients come from autograd over the composed graph. Comparison ops
return 0/1 in the input's type, like the reference.
"""
from __future__ import annotations

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
_binary_scalar("_equal_scalar", _cmp(torch.eq))
_binary_scalar("_not_equal_scalar", _cmp(torch.ne))
_binary_scalar("_greater_scalar", _cmp(torch.gt))
_binary_scalar("_greater_equal_scalar", _cmp(torch.ge))
_binary_scalar("_lesser_scalar", _cmp(torch.lt))
_binary_scalar("_lesser_equal_scalar", _cmp(torch.le))

# --- unary -------------------------------------------------------------------
_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("relu", torch.relu)
_unary("_copy", lambda x: x.clone())
_unary("BlockGrad", lambda x: x.detach())

alias("_copy", "identity")
alias("BlockGrad", "stop_gradient")
