"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference python/mxnet/
initializer.py) for ``InitDesc``, the name-suffix dispatch of
``Initializer``, ``Zero`` / ``One`` / ``Constant`` / ``Uniform`` /
``Normal`` / ``Orthogonal`` / ``Xavier`` / ``MSRAPrelu`` / ``Bilinear`` /
``LSTMBias`` / ``FusedRNN`` (by name in ``init_registry``), and ``Mixed``
(an initializer per name pattern) and ``Load`` (from saved arrays), which
take a name and an array as the others do. Random draws come
from numpy, as the reference's do, from the ``rng`` (a
``np.random.RandomState``) the caller passes, or numpy's global state when
it passes none — so one seed gives both packages the same weights, the
packed blob of a fused RNN included. The draw lands in the array's tensor
in place.
"""
from __future__ import annotations

import json
import re

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
    subclass's rule, ``bias`` by its bias rule (0 unless it says
    otherwise), ``beta`` with 0, ``gamma`` with 1, a fused RNN's packed
    ``parameters`` by its blob rule; an ``__init__`` attribute on the
    descriptor names another initializer."""

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
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("parameters"):
            self._init_parameters(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            arr[:] = 0.0
        elif name.endswith("moving_var") or name.endswith("running_var"):
            arr[:] = 1.0
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            arr[:] = 0.0
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s. Default "
                'initialization is limited to "weight", "bias", "gamma" '
                '(1.0), and "beta" (0.0).' % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError()

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_bilinear(self, _, arr):
        """A bilinear upsampling kernel over the last two axes."""
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype="float32")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_parameters(self, _, arr):
        """A fused RNN's packed blob under a generic initializer: a small
        uniform fill, as the reference's (a flat blob hides the matrices
        that shape-dependent rules such as Xavier need; ``FusedRNN`` fills
        it matrix by matrix)."""
        arr[:] = self._random.uniform(-0.07, 0.07, arr.shape).astype(
            np.float32)


register = registry.get_register_func(Initializer, "initializer")
create = registry.get_create_func(Initializer, "initializer")
#: lowercased name -> initializer class (the reference's ``init_registry``)
init_registry = registry._REGISTRY[Initializer]


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
class Orthogonal(Initializer):
    """``scale`` times the orthogonal factor of the SVD of a uniform(-1, 1)
    (or, ``rand_type="normal"``, standard normal) (nout, nin) draw."""

    def __init__(self, scale=1.414, rand_type="uniform", rng=None):
        super().__init__(rng=rng, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self._random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * res).reshape(arr.shape).astype(np.float32)


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


@register
class MSRAPrelu(Xavier):
    """Xavier, gaussian, with magnitude 2 / (1 + slope^2) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25, rng=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         rng=rng)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel (a ``Deconvolution``'s weight)."""

    def _init_weight(self, desc, arr):
        self._init_bilinear(desc, arr)


@register
class LSTMBias(Initializer):
    """An LSTM cell's i2h bias: 0, with the forget gate's quarter (gate
    order i, f, g, o) at ``forget_bias``."""

    def __init__(self, forget_bias=1.0, rng=None):
        super().__init__(rng=rng, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_bias(self, _, arr):
        v = np.zeros(arr.shape, np.float32)
        num_hidden = int(arr.shape[0] / 4)
        v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v

    _init_weight = _init_bias  # names without the _bias suffix too


_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


@register
class FusedRNN(Initializer):
    """Initializer of a fused RNN's packed parameter blob: each weight
    matrix by the inner initializer ``init`` (a uniform(-0.07, 0.07) fill
    without one), the biases 0 and each LSTM i2h forget-gate bias
    ``forget_bias``. ``FusedRNNCell`` tags its blob with it."""

    def __init__(self, init=None, num_hidden=0, num_layers=0, mode="lstm",
                 bidirectional=False, forget_bias=1.0, rng=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, rng=rng, **kwargs)
        super().__init__(rng=rng, init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        # a plain weight under FusedRNN: the inner initializer's rule
        if self._init is not None:
            self._init._init_weight(desc, arr)
        else:
            arr[:] = self._random.uniform(-0.07, 0.07, arr.shape).astype(
                np.float32)

    def _fill(self, shape, name):
        """One weight matrix (or the flat blob) by the inner rule."""
        if self._init is None:
            return self._random.uniform(-0.07, 0.07, shape).astype(
                np.float32)
        buf = np.zeros(shape, np.float32)
        self._init._init_weight(InitDesc(name), buf)
        return buf

    def _init_parameters(self, desc, arr):
        """Matrix by matrix, in the packed layout (``ops/rnn_fused.py``):
        per layer per direction wi then wh, then every bias pair (bi, bh;
        gate order i, f, g, o for an LSTM)."""
        kw = self._kwargs
        h = int(kw.get("num_hidden") or 0)
        layers = int(kw.get("num_layers") or 0)
        mode = kw.get("mode", "lstm")
        dirs = 2 if kw.get("bidirectional") else 1
        gates = _GATES.get(mode, 0)
        total = int(np.prod(arr.shape))
        bias_total = layers * dirs * gates * h * 2
        if not (h and layers and gates and bias_total < total):
            # unknown layout: a shape-independent inner rule still fills
            # the flat blob; a shape-dependent one (Xavier) would not, so
            # the plain uniform fill stands in
            if isinstance(self._init, (Uniform, Normal, Constant, Zero,
                                       One)):
                arr[:] = self._fill((total,), str(desc)).reshape(arr.shape)
            else:
                arr[:] = self._random.uniform(-0.07, 0.07, (total,)).astype(
                    np.float32).reshape(arr.shape)
            return
        # the input size, from the blob's length
        per_upper = dirs * gates * h * (dirs * h + h)  # each layer > 0
        ni = (total - bias_total - (layers - 1) * per_upper) \
            // (dirs * gates * h) - h
        v = np.empty(total, np.float32)
        p = 0
        for layer in range(layers):
            in_sz = ni if layer == 0 else h * dirs
            for _ in range(dirs):
                for cols, tag in ((in_sz, "wi"), (h, "wh")):
                    size = gates * h * cols
                    v[p:p + size] = self._fill(
                        (gates * h, cols),
                        "%s_l%d_%s" % (desc, layer, tag)).reshape(-1)
                    p += size
        biases = np.zeros((2 * layers * dirs, gates * h), np.float32)
        if mode == "lstm" and self.forget_bias:
            biases[0::2, h:2 * h] = self.forget_bias  # the bi rows only
        v[p:] = biases.reshape(-1)
        arr[:] = v.reshape(arr.shape)


class Mixed:
    """The initializer of the first of ``patterns`` (regular expressions)
    that matches a parameter's name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: %d patterns, %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern"
                         % name)


class Load:
    """Parameters from saved arrays (a dict, or a file ``nd.load`` reads;
    ``arg:`` / ``aux:`` prefixes dropped); a name not among them goes to
    ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        from . import ndarray as nd

        if isinstance(param, str):
            param = nd.load(param)
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise ValueError("Parameter %s shape mismatch" % name)
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise ValueError("Cannot init %s: not found and no default"
                                 % name)
            self.default_init(name, arr)
