"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference python/mxnet/
initializer.py) for ``InitDesc``, the name-suffix dispatch of
``Initializer`` and ``Zero`` / ``One`` / ``Constant`` / ``Uniform`` /
``Normal`` / ``Xavier``. Random draws come from numpy, as the reference's
do, from the ``rng`` (a ``np.random.RandomState``) the caller passes, or
numpy's global state when it passes none — so one seed gives both
packages the same weights. The draw lands in the array's tensor in place.
"""
from __future__ import annotations

import json

import numpy as np

from . import registry
from .base import MXNetError


class InitDesc(str):
    """A parameter name with attributes (reference InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Fills an array by the suffix of its name: ``weight`` by the
    subclass's rule, ``bias`` / ``beta`` with 0, ``gamma`` with 1; an
    ``__init__`` attribute on the descriptor names another initializer."""

    def __init__(self, rng=None, **kwargs):
        self._kwargs = kwargs
        self.rng = rng

    @property
    def _random(self):
        return np.random if self.rng is None else self.rng

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            clean = InitDesc(str(desc), {k: v for k, v in desc.attrs.items()
                                         if k != "__init__"},
                             desc.global_init)
            create(klass, rng=self.rng, **kwargs)(clean, arr)
            return
        name = desc.lower()
        if name.endswith("bias") or name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            arr[:] = 0.0
        elif name.endswith("moving_var") or name.endswith("running_var"):
            arr[:] = 1.0
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s. Default "
                'initialization is limited to "weight", "bias", "gamma" '
                '(1.0), and "beta" (0.0).' % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError()


register = registry.get_register_func(Initializer, "initializer")
create = registry.get_create_func(Initializer, "initializer")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0, rng=None):
        super().__init__(rng=rng, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, rng=None):
        super().__init__(rng=rng, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self._random.uniform(-self.scale, self.scale,
                                      arr.shape).astype(np.float32)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng=rng, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self._random.normal(0, self.sigma,
                                     arr.shape).astype(np.float32)


@register
class Xavier(Initializer):
    """Uniform or gaussian with scale sqrt(magnitude / factor), the factor
    being fan_in, fan_out or their mean (``factor_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 rng=None):
        super().__init__(rng=rng, rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factors[self.factor_type])
        if self.rnd_type == "uniform":
            draw = self._random.uniform(-scale, scale, shape)
        elif self.rnd_type == "gaussian":
            draw = self._random.normal(0, scale, shape)
        else:
            raise ValueError("Unknown random type")
        arr[:] = draw.astype(np.float32)
