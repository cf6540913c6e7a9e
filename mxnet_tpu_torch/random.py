"""Global random state.

Counterpart of ``mxnet_tpu/random.py`` (reference python/mxnet/random.py).
The reference hands operators PRNG streams through its resource manager
and the JAX package splits a key; here each device has one
``torch.Generator``, made on first use and seeded from the last
:func:`seed` (0 before any call). An operator that draws
(``OpDef.needs_rng``: ``Dropout``, the ``RNN`` op's dropout between
layers) gets its device's generator as ``OpContext.rng``, and each draw
advances it, so every training forward draws new masks.

On the card the generator is Philox, counter based: a captured training
step registers it with its CUDA graph (``executor._TrainStep``), and each
replay draws from the offset the same step run eagerly would have used.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

_lock = threading.Lock()
_state = {"seed": 0}
_generators = {}


def seed(seed_state: int) -> None:
    """Seed every device's generator (those made later too) and numpy's
    global state with ``seed_state & 0x7FFFFFFF``, as the reference's
    seed covers host-side initializers and shuffles as well."""
    s = int(seed_state)
    with _lock:
        _state["seed"] = s
        for gen in _generators.values():
            gen.manual_seed(s)
        np.random.seed(s & 0x7FFFFFFF)


def generator(device=None) -> torch.Generator:
    """The generator of ``device`` (None = the card), made on first use.
    Seeding keeps the object, so a CUDA graph that registered it follows
    a later :func:`seed`."""
    device = resolve_device(device)
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_state["seed"])
            _generators[device] = gen
        return gen


def keep_mask(shape, keep, gen, device, dtype):
    """A dropout mask: each entry 1 with probability ``keep``, else 0, in
    ``dtype`` (one f32 uniform draw per entry from ``gen``, kept where
    below ``keep``); raises without a generator, so no draw falls back to
    PyTorch's global one."""
    if gen is None:
        raise MXNetError("dropout in training draws from the device's "
                         "generator (OpContext.rng), and none was given")
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return (u < keep).to(dtype)
