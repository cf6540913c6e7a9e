"""Reductions and broadcasting binary operators.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py`` (reference
broadcast_reduce_op*.cc): ``sum`` / ``mean`` / ``prod`` / ``max`` / ``min``
over ``axis`` (None = all, ``exclude`` inverts the set), and the
``broadcast_*`` binary family that symbol and NDArray arithmetic compose to,
and ``broadcast_to``.
"""
from __future__ import annotations

import numpy as np
import torch

from .elemwise import _cmp
from .registry import alias, defop


def _norm_axis(axis, ndim):
    if axis is None or axis == ():
        return None
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    return tuple(int(a) % ndim for a in axis)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, fn):
    spec = {"axis": None, "keepdims": False, "exclude": False}

    def impl(attrs, data, _f=fn):
        axis = _norm_axis(attrs["axis"], data.dim())
        if attrs["exclude"] and axis is not None:
            axis = tuple(i for i in range(data.dim()) if i not in axis)
        if axis is None:
            axis = tuple(range(data.dim()))
        if not axis:
            return data
        return _f(data, axis, bool(attrs["keepdims"]))

    defop(name, arg_names=("data",), param_spec=spec)(impl)


_reduce("sum", lambda x, dim, keepdim: torch.sum(x, dim=dim,
                                                 keepdim=keepdim))
_reduce("mean", lambda x, dim, keepdim: torch.mean(x, dim=dim,
                                                   keepdim=keepdim))
_reduce("prod", _prod)
_reduce("max", _amax)
_reduce("min", _amin)
alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


def _broadcast_binary(name, fn):
    defop(name, arg_names=("lhs", "rhs"), param_spec={})(
        lambda attrs, lhs, rhs, _f=fn: _f(lhs, rhs))


_broadcast_binary("broadcast_add", torch.add)
_broadcast_binary("broadcast_sub", torch.sub)
_broadcast_binary("broadcast_mul", torch.mul)
_broadcast_binary("broadcast_div", torch.div)
_broadcast_binary("broadcast_mod", torch.remainder)
_broadcast_binary("broadcast_power", torch.pow)
_broadcast_binary("broadcast_maximum", torch.maximum)
_broadcast_binary("broadcast_minimum", torch.minimum)
_broadcast_binary("broadcast_equal", _cmp(torch.eq))
_broadcast_binary("broadcast_not_equal", _cmp(torch.ne))
_broadcast_binary("broadcast_greater", _cmp(torch.gt))
_broadcast_binary("broadcast_greater_equal", _cmp(torch.ge))
_broadcast_binary("broadcast_lesser", _cmp(torch.lt))
_broadcast_binary("broadcast_lesser_equal", _cmp(torch.le))
alias("broadcast_add", "broadcast_plus")
alias("broadcast_sub", "broadcast_minus")


@defop("broadcast_to", arg_names=("data",), param_spec={"shape": ()})
def _broadcast_to(attrs, data):
    """Broadcast to ``shape``, where 0 keeps the input's dim (reference
    broadcast_reduce_op_value.cc). An ``expand`` view: the broadcast axes
    have stride 0."""
    shape = tuple(int(s) for s in attrs["shape"])
    return data.expand(tuple(d if s == 0 else s
                             for s, d in zip(shape, data.shape)))


@defop("where", arg_names=("condition", "x", "y"), param_spec={},
       no_grad_inputs=("condition",))
def _where(attrs, condition, x, y):
    """Elementwise select, ``x`` where ``condition`` is non-zero (reference
    control_flow_op.cc where); a 1-D condition over a larger ``x`` selects
    whole rows."""
    if condition.shape != x.shape and condition.dim() == 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)
