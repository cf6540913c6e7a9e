"""Initialization and sampling operators.

Counterpart of ``mxnet_tpu/ops/init_random.py`` (reference src/operator/
tensor/init_op.cc and sample_op.cc): ``_zeros`` / ``_ones`` / ``_full`` /
``_arange`` / ``_eye``, ``zeros_like`` / ``ones_like``, and the sampling
ops ``_random_uniform`` / ``_random_normal`` / ``_random_gamma`` /
``_random_exponential`` (with the reference's ``uniform`` / ``normal`` /
``_sample_*`` aliases). An op without inputs makes its tensor on the
device of the graph that runs it (``OpContext.device``), or, called
imperatively, on its ``ctx`` attribute (None is the card); every value is
computed there, so the ops run inside a captured CUDA graph.

A sampling op draws from its device's ``torch.Generator``
(``OpContext.rng``, ``random.generator``): seeded by ``random.seed``, and
advanced by each draw. The card's generator is another algorithm than the
CPU's, so the two devices draw different values from one seed (the
dropout masks' precedent); a captured step registers the generator with
its graph, so each replay draws anew.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .registry import alias, defop

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


def _device(attrs, ctx):
    return ctx.device if ctx.device is not None else resolve_device(
        attrs["ctx"])


@defop("_full", arg_names=(),
       param_spec=dict(_SPEC, value=0.0), simple=False)
def _full(attrs, inputs, aux, ctx):
    return (torch.full(tuple(attrs["shape"]), attrs["value"],
                       dtype=_dtype(attrs["dtype"]),
                       device=_device(attrs, ctx)),), ()


@defop("_arange", arg_names=(),
       param_spec={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                   "ctx": None, "dtype": "float32"}, simple=False)
def _arange(attrs, inputs, aux, ctx):
    """``start + i * step`` (in f64, then the type) over numpy's range
    (``stop`` None: ``[0, start)``), each value ``repeat`` times."""
    start, stop, step = attrs["start"], attrs["stop"], attrs["step"]
    if stop is None:
        start, stop = 0.0, start
    n = len(np.arange(start, stop, step))
    out = torch.arange(n, dtype=torch.float64, device=_device(attrs, ctx))
    out = (out * float(step) + float(start)).to(_dtype(attrs["dtype"]))
    if int(attrs["repeat"]) != 1:
        out = torch.repeat_interleave(out, int(attrs["repeat"]))
    return (out,), ()


@defop("_eye", arg_names=(),
       param_spec={"N": 0, "M": 0, "k": 0, "ctx": None, "dtype": "float32"},
       simple=False)
def _eye(attrs, inputs, aux, ctx):
    """Ones on the ``k``-th diagonal of an (N, M or N) matrix."""
    n = int(attrs["N"])
    m = int(attrs["M"]) or n
    device = _device(attrs, ctx)
    rows = torch.arange(n, device=device).reshape(n, 1)
    cols = torch.arange(m, device=device).reshape(1, m)
    return ((cols - rows == int(attrs["k"])).to(_dtype(attrs["dtype"])),), ()


@defop("zeros_like", arg_names=("data",), param_spec={})
def _zeros_like(attrs, data):
    """Zeros of ``data``'s shape, type and device (no gradient flows)."""
    return torch.zeros_like(data)


# --- sampling (reference sample_op.cc) ---------------------------------------
def _draw(attrs, ctx, fill):
    """A tensor of ``attrs["shape"]`` on the op's device, filled in f32 by
    ``fill(empty_f32, generator)`` and cast to the op's type (shape
    inference, on the meta device, draws nothing)."""
    device = _device(attrs, ctx)
    if device.type == "meta":
        return (torch.empty(tuple(attrs["shape"]), device=device,
                            dtype=_dtype(attrs["dtype"])),), ()
    if ctx.rng is None:
        raise MXNetError("a sampling op draws from the device's generator "
                         "(OpContext.rng), and none was given")
    buf = torch.empty(tuple(attrs["shape"]), dtype=torch.float32,
                      device=device)
    return (fill(buf, ctx.rng).to(_dtype(attrs["dtype"])),), ()


@defop("_random_uniform", arg_names=(),
       param_spec=dict(_SPEC, low=0.0, high=1.0), needs_rng=True,
       simple=False)
def _random_uniform(attrs, inputs, aux, ctx):
    """Uniform on ``[low, high)``."""
    return _draw(attrs, ctx, lambda b, g: b.uniform_(
        attrs["low"], attrs["high"], generator=g))


@defop("_random_normal", arg_names=(),
       param_spec=dict(_SPEC, loc=0.0, scale=1.0), needs_rng=True,
       simple=False)
def _random_normal(attrs, inputs, aux, ctx):
    """``loc + scale * N(0, 1)``."""
    return _draw(attrs, ctx, lambda b, g: attrs["loc"] + attrs["scale"]
                 * b.normal_(generator=g))


alias("_random_uniform", "uniform", "_sample_uniform")
alias("_random_normal", "normal", "_sample_normal")


@defop("_random_gamma", arg_names=(),
       param_spec=dict(_SPEC, alpha=1.0, beta=1.0), needs_rng=True,
       simple=False)
def _random_gamma(attrs, inputs, aux, ctx):
    """Gamma of shape ``alpha`` and scale ``beta``."""
    return _draw(attrs, ctx, lambda b, g: torch._standard_gamma(
        b.fill_(attrs["alpha"]), generator=g) * attrs["beta"])


@defop("_random_exponential", arg_names=(),
       param_spec=dict(_SPEC, lam=1.0), needs_rng=True, simple=False)
def _random_exponential(attrs, inputs, aux, ctx):
    """Exponential of rate ``lam``."""
    return _draw(attrs, ctx, lambda b, g: b.exponential_(1.0, generator=g)
                 / attrs["lam"])
