"""Constant-creating operators.

Counterpart of ``_zeros`` / ``_ones`` / ``ones_like`` of
``mxnet_tpu/ops/init_random.py`` (reference src/operator/tensor/
init_op.cc), which ``symbol.zeros`` / ``symbol.ones``, the RNN cells'
``begin_state`` and ``ZoneoutCell``'s masks build on. An op without
inputs makes its tensor on the device of the graph that runs it
(``OpContext.device``), or, called imperatively, on its ``ctx`` attribute
(None is the card). The rest of the module (``_arange``, ``_eye``,
``zeros_like``, the sampling ops) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import resolve_device
from .registry import defop

_SPEC = {"shape": (), "ctx": None, "dtype": "float32"}


def _dtype(name):
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(name or "float32"))).dtype


def _creator(name, fill):
    def impl(attrs, inputs, aux, ctx):
        device = ctx.device if ctx.device is not None else resolve_device(
            attrs["ctx"])
        return (torch.full(tuple(attrs["shape"]), fill,
                           dtype=_dtype(attrs["dtype"]),
                           device=device),), ()

    defop(name, arg_names=(), param_spec=_SPEC, simple=False)(impl)


_creator("_zeros", 0)
_creator("_ones", 1)


@defop("ones_like", arg_names=("data",), param_spec={})
def _ones_like(attrs, data):
    """Ones of ``data``'s shape, type and device (no gradient flows)."""
    return torch.ones_like(data)
