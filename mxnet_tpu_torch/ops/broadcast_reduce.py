"""Reductions, index reductions and broadcasting binary operators.

Counterpart of ``mxnet_tpu/ops/broadcast_reduce.py`` (reference
broadcast_reduce_op*.cc): ``sum`` / ``mean`` / ``prod`` / ``nansum`` /
``nanprod`` / ``max`` / ``min`` over ``axis`` (None = all, ``exclude``
inverts the set); ``argmax`` / ``argmin`` / ``argmax_channel`` and
``pick``, whose indices are floats of the data's type; the
``broadcast_*`` binary family that symbol and NDArray arithmetic compose
to, with the logical ops (0/1 in the left operand's type);
``broadcast_to`` / ``broadcast_axis``; and ``norm`` (L2, or L1 with
``ord=1``; ``Monitor``'s default statistic).
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
_reduce("nansum", lambda x, dim, keepdim: torch.nansum(x, dim=dim,
                                                       keepdim=keepdim))
_reduce("nanprod", lambda x, dim, keepdim: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim))
_reduce("max", _amax)
_reduce("min", _amin)
alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@defop("norm", arg_names=("data",),
       param_spec={"ord": 2, "axis": None, "keepdims": False})
def _norm(attrs, data):
    """L2 (or, with ``ord=1``, L1) norm over ``axis`` (None: all), as
    broadcast_reduce_op_value.cc norm."""
    axis = _norm_axis(attrs["axis"], data.dim())
    if axis is None:
        axis = tuple(range(data.dim()))
    keep = bool(attrs["keepdims"])
    if attrs["ord"] == 1:
        return torch.sum(torch.abs(data), dim=axis, keepdim=keep)
    return torch.sqrt(torch.sum(torch.square(data), dim=axis, keepdim=keep))


def _arg_reduce(name, fn):
    @defop(name, arg_names=("data",),
           param_spec={"axis": None, "keepdims": False})
    def impl(attrs, data, _f=fn):
        """The index of the extreme along ``axis`` (None: of the flattened
        data), the first among ties, as a float of the data's type."""
        axis = attrs["axis"]
        if axis is None:
            return _f(data.reshape(-1), dim=0).to(data.dtype)
        out = _f(data, dim=int(axis))
        if attrs["keepdims"]:
            out = out.unsqueeze(int(axis))
        return out.to(data.dtype)


# torch.argmax / argmin return the first index among ties, as jnp's do
_arg_reduce("argmax", torch.argmax)
_arg_reduce("argmin", torch.argmin)


@defop("argmax_channel", arg_names=("data",), param_spec={})
def _argmax_channel(attrs, data):
    """argmax over axis 1 (reference broadcast_reduce_op_index.cc)."""
    return torch.argmax(data, dim=1).to(data.dtype)


@defop("pick", arg_names=("data", "index"), no_grad_inputs=("index",),
       param_spec={"axis": -1, "keepdims": False, "mode": "clip"})
def _pick(attrs, data, index):
    """One element per position of ``index`` along ``axis``; an index
    outside [0, n) clips to 0 or n - 1, or wraps (``mode="wrap"``, a
    modulo). ``index`` comes keepdims-shaped (size 1 at ``axis``) or
    without that axis (reference broadcast_reduce_op_index.cc pick)."""
    ax = attrs["axis"]
    ax = data.dim() - 1 if ax is None else int(ax) % data.dim()
    n = data.shape[ax]
    idx = index.long()
    idx = torch.remainder(idx, n) if attrs["mode"] == "wrap" \
        else idx.clamp(0, n - 1)
    if idx.dim() == data.dim() - 1:
        idx = idx.unsqueeze(ax)
    out = torch.gather(data, ax, idx.expand(
        tuple(1 if i == ax else s for i, s in enumerate(data.shape))))
    return out if attrs["keepdims"] else out.squeeze(ax)


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


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
_broadcast_binary("broadcast_hypot", torch.hypot)
_broadcast_binary("broadcast_logical_and", _logical(torch.logical_and))
_broadcast_binary("broadcast_logical_or", _logical(torch.logical_or))
_broadcast_binary("broadcast_logical_xor", _logical(torch.logical_xor))
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


@defop("broadcast_axis", arg_names=("data",),
       param_spec={"axis": (), "size": ()})
def _broadcast_axis(attrs, data):
    """Broadcast size-1 ``axis`` (one or a tuple) to ``size`` (reference
    broadcast_reduce_op_value.cc broadcast_axis); an ``expand`` view."""
    axes, sizes = attrs["axis"], attrs["size"]
    if isinstance(axes, (int, np.integer)):
        axes, sizes = (axes,), (sizes,)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[int(a)] = int(s)
    return data.expand(tuple(tgt))


alias("broadcast_axis", "broadcast_axes")


@defop("where", arg_names=("condition", "x", "y"), param_spec={},
       no_grad_inputs=("condition",))
def _where(attrs, condition, x, y):
    """Elementwise select, ``x`` where ``condition`` is non-zero (reference
    control_flow_op.cc where); a 1-D condition over a larger ``x`` selects
    whole rows."""
    if condition.shape != x.shape and condition.dim() == 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)
