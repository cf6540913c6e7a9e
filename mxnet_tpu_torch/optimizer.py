"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference python/mxnet/
optimizer.py): the registry, the ``Optimizer`` base with lr / wd
multipliers (no weight decay by default for ``_bias`` / ``_gamma`` /
``_beta``), ``rescale_grad``, ``clip_gradient`` and an ``lr_scheduler``
hook, the ``Updater`` a training loop calls per parameter, and the whole
zoo: SGD (with and without momentum), NAG, SGLD, ccSGD, DCASGD, Adam,
AdaGrad, RMSProp (plain and centered), AdaDelta, Ftrl and Test. SGD with
momentum (ccSGD too) and Adam run the fused CUDA kernels
``sgd_mom_update`` / ``adam_update``, RMSProp the ``rmsprop_update`` /
``rmspropalex_update`` ops; the other rules are PyTorch expressions on the
weight's device, as the JAX package's are ``jnp`` ones. Every update
writes the weight and the state in place (the reference rebinds new
arrays): DCASGD and Test therefore copy the weight into their state where
the JAX package aliases it. The reference's whole-tree jitted
``update_all`` has no counterpart: here ``update_all`` loops, one update
per parameter. ``Updater.get_states`` / ``set_states`` are the JAX
package's blob (a pickle of numpy arrays, tuples of them or None by index
plus ``__update_counts__``), so optimizer states cross between the
packages in both directions.

Clipping follows the JAX package on each path: an eager ``update`` of
NAG, SGLD, DCASGD, AdaGrad, AdaDelta and Ftrl clips whenever
``clip_gradient`` is not None, a ``pure_rule`` and the update ops only
when it is > 0. SGLD draws its noise from the weight's device generator
(``random.generator``), the JAX package from numpy's global state.

The whole training step (``Executor.make_train_step``, ``Module.fit_step``)
takes each optimizer's ``pure_rule()``: fn(w, g, state, lr, wd) -> (w,
state), with lr and wd per parameter from ``effective_lr_wd`` (Adam's bias
correction folded in) as 0-d f32 device tensors, so a step captured in a
CUDA graph reads them where they lie. :class:`FusedUpdate` is that
step's update over a list of parameters. The rules of SGD with momentum and
of Adam run the fused kernels' device-lr entry points, in place, and equal
the ``Updater``'s updates bit for bit; NAG, AdaGrad, RMSProp and AdaDelta
have rules of their own (PyTorch on tensors, in place), as the JAX
package's; SGLD, DCASGD, Ftrl and Test have none, so a ``Module`` runs
them through the ``Updater``.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict

import numpy as np
import torch

from . import ndarray as nd
from . import random as _random
from . import registry
from .ndarray import NDArray
from .ops.kernels import fused_update as _fu


def cached_lr_wd_arrays(cache, lw, device):
    """(lr_arr, wd_arr, new_cache): ``lw`` (n, 2) f32 host values of each
    parameter's (lr, wd) as two f32 tensors on ``device``, uploaded again
    only when a value changed: the cache keys on the contents, so an
    in-place ``opt.lr_mult[name] = 2.0`` is seen."""
    lw = np.asarray(lw, np.float32)
    if cache is None or cache[0].shape != lw.shape or \
            not np.array_equal(cache[0], lw) or cache[1].device != device:
        cache = (lw.copy(), torch.tensor(lw[:, 0], device=device),
                 torch.tensor(lw[:, 1], device=device))
    return cache[1], cache[2], cache


def state_leaves(state, copy=False):
    """The tensors of an optimizer state (None, an NDArray or a tuple of
    NDArrays), in its structure; copies with ``copy``."""
    def leaf(x):
        if x is None:
            return None
        return x._data.clone() if copy else x._data

    if isinstance(state, tuple):
        return tuple(leaf(x) for x in state)
    return leaf(state)


def _state_structure(s):
    """(shape, dtype) signature of a state tree: a hyperparameter change
    that changes what ``create_state`` builds (momentum 0 -> 0.9 turns
    None into a buffer) changes it."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_structure(x) for x in s)
    return (tuple(s.shape), str(s.dtype))


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                if "__lr_mult__" in attrs.get(name, {}):
                    self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
                if "__wd_mult__" in attrs.get(name, {}):
                    self.wd_mult[name] = float(attrs[name]["__wd_mult__"])

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def effective_lr_wd(self, index):
        """(lr, wd) applied to ``index`` at the current step: schedule,
        multipliers and any count-dependent folding (Adam's bias
        correction) resolved on the host."""
        return self._get_lr(index), self._get_wd(index)

    def pure_rule(self):
        """fn(w, g, state, lr, wd) -> (new_w, new_state), the update of one
        parameter with every hyperparameter but lr and wd fixed, or None
        where the optimizer has none. lr and wd are 0-d f32 tensors on the
        weight's device (views into per-parameter arrays); a rule may
        update ``w`` and ``state`` in place and return them. A caller that
        keeps a rule keys it on :meth:`_hyperparam_key`."""
        return None

    # entered through lr / wd (per step) or bookkeeping: every other
    # attribute is fixed inside pure_rule() and keys a kept rule
    _DYNAMIC_OR_BOOKKEEPING = frozenset({
        "lr", "wd", "lr_scheduler", "lr_mult", "wd_mult", "idx2name",
        "sym", "num_update", "begin_num_update", "_index_update_count"})

    def _hyperparam_key(self):
        """Hashable tuple of every hyperparameter pure_rule() fixes; a
        change (momentum or betas on a schedule) changes it."""
        items = []
        for k in sorted(vars(self)):
            if k in self._DYNAMIC_OR_BOOKKEEPING:
                continue
            v = getattr(self, k)
            if isinstance(v, np.generic):
                v = v.item()
            if v is None or isinstance(v, (int, float, bool, str)):
                items.append((k, v))
            else:
                items.append((k, repr(v)))
        return tuple(items)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Reference semantics: parameters whose name does not end in
        _weight / _gamma default to wd_mult 0, symbol attributes override,
        explicit arguments override both."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight")
                                or n.endswith("_gamma"))}
        if self.sym is not None:
            attrs = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if "__wd_mult__" in attrs.get(name, {}):
                    self.wd_mult[name] = float(attrs[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        name = self.idx2name.get(index, index)
        return lr * self.lr_mult.get(name, 1.0)

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        if isinstance(name, str) and name not in self.wd_mult and (
                name.endswith("_bias") or name.endswith("_gamma")
                or name.endswith("_beta")):
            # reference default: no decay for bias / norm parameters
            wd = 0.0
        return wd * self.wd_mult.get(name, 1.0)

    def _clip_attr(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient


register = registry.get_register_func(Optimizer, "optimizer")
create = registry.get_create_func(Optimizer, "optimizer")


def _zeros_like_state(weight):
    """A state buffer of the weight's shape, type and device."""
    return nd.zeros(weight.shape, weight.context, weight._data.dtype)


@register
class SGD(Optimizer):
    """SGD, with momentum through the fused ``sgd_mom_update`` kernel."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                 "rescale_grad": self.rescale_grad,
                 "clip_gradient": self._clip_attr()}
        if state is None:
            nd.sgd_update(weight, grad, out=weight, **attrs)
        else:
            nd.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                              **attrs)

    def pure_rule(self):
        """Plain SGD: w - lr * (clip(rescale * g) + wd * w), a new tensor
        (``sgd_update``'s math). With momentum: the fused kernel's
        device-lr entry point, in place."""
        momentum, rescale = self.momentum, self.rescale_grad
        clip = self._clip_attr()

        def rule(w, g, s, lr, wd):
            if s is None:
                return _fu.sgd_update(w, g, lr, wd, rescale, clip), None
            _fu.sgd_mom_update_lr(w, g, s, lr.reshape(1), wd.reshape(1), 0,
                                  momentum, rescale, clip)
            return w, s

        return rule


@register
class Adam(Optimizer):
    """Adam through the fused ``adam_update`` kernel; the bias correction
    is folded into lr, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def effective_lr_wd(self, index):
        """lr with the bias correction of the index's count folded in."""
        t = self._index_update_count.get(index, self.begin_num_update) or 1
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        return lr, self._get_wd(index)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self.effective_lr_wd(index)
        mean, var = state
        nd.adam_update(weight, grad, mean, var, lr=lr, wd=wd,
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                       clip_gradient=self._clip_attr())

    def pure_rule(self):
        """The fused kernel's device-lr entry point, in place."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        rescale, clip = self.rescale_grad, self._clip_attr()

        def rule(w, g, s, lr, wd):
            mean, var = s
            _fu.adam_update_lr(w, g, mean, var, lr.reshape(1), wd.reshape(1),
                               0, b1, b2, eps, rescale, clip)
            return w, s

        return rule



def _scaled(grad, rescale, clip, eager):
    """``rescale * grad``, clamped to [-clip, clip]: by an eager update
    whenever ``clip`` is set, by a pure rule only when it is > 0 (the JAX
    package's two paths)."""
    g = grad * rescale
    if clip is not None and (eager or clip > 0):
        g = g.clamp(-clip, clip)
    return g


def _nag_step(w, g, mom, lr, wd, momentum):
    """NAG on ``w`` (and ``mom``) in place from the scaled gradient."""
    g = g + wd * w
    if mom is None:
        w.sub_(lr * g)
        return
    mom.mul_(momentum).add_(g)
    w.sub_(lr * (g + momentum * mom))


def _adagrad_step(w, g, history, lr, wd, eps):
    history.add_(g * g)
    w.sub_(lr * (g / torch.sqrt(history + eps) + wd * w))


def _adadelta_step(w, g, acc_g, acc_delta, wd, rho, eps):
    """AdaDelta in place; it takes no learning rate."""
    acc_g.mul_(rho).add_((1 - rho) * g * g)
    delta = torch.sqrt(acc_delta + eps) / torch.sqrt(acc_g + eps) * g
    acc_delta.mul_(rho).add_((1 - rho) * delta * delta)
    w.copy_(w - delta - wd * w)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        _nag_step(weight._data, g, None if state is None else state._data,
                  self._get_lr(index), self._get_wd(index), self.momentum)

    def pure_rule(self):
        momentum, rescale, clip = (self.momentum, self.rescale_grad,
                                   self.clip_gradient)

        def rule(w, g, s, lr, wd):
            _nag_step(w, _scaled(g, rescale, clip, False), s, lr, wd,
                      momentum)
            return w, s

        return rule


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w - lr / 2 * (g + wd * w)
    plus N(0, lr) noise, drawn on the weight's device from its generator
    (``random.generator``)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device, dtype=w.dtype) * math.sqrt(lr)
        w.copy_(w - (lr / 2) * (g + wd * w) + noise)


@register
class ccSGD(SGD):
    """SGD under the reference's name for its C++ implementation."""


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD. The state is (momentum or None,
    the weight before the last update): a copy, where the JAX package
    aliases the array it is about to replace."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like_state(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        mom, previous = state
        comp = g + wd * w + self.lamda * g * g * (w - previous._data)
        if mom is not None:
            mom._data.copy_(self.momentum * mom._data - lr * comp)
            delta = mom._data
        else:
            delta = -lr * comp
        previous._data.copy_(w)
        w.add_(delta)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        _adagrad_step(weight._data, g, state._data, self._get_lr(index),
                      self._get_wd(index), self.float_stable_eps)

    def pure_rule(self):
        eps, rescale, clip = (self.float_stable_eps, self.rescale_grad,
                              self.clip_gradient)

        def rule(w, g, s, lr, wd):
            _adagrad_step(w, _scaled(g, rescale, clip, False), s, lr, wd,
                          eps)
            return w, s

        return rule


@register
class RMSProp(Optimizer):
    """RMSProp through the ``rmsprop_update`` op, or with ``centered``
    (Graves 2013) ``rmspropalex_update``; ``clip_weights`` clamps the
    weight after each update. Note the optimizer's ``gamma1`` default
    (0.9) differs from the ops' (0.95), as in the reference."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like_state(weight), _zeros_like_state(weight),
                    _zeros_like_state(weight))
        return (_zeros_like_state(weight),)

    def _clip_weights_attr(self):
        return self.clip_weights if self.clip_weights else -1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                 "rescale_grad": self.rescale_grad, "gamma1": self.gamma1,
                 "epsilon": self.epsilon, "clip_gradient": self._clip_attr(),
                 "clip_weights": self._clip_weights_attr()}
        if not self.centered:
            nd.rmsprop_update(weight, grad, state[0], **attrs)
        else:
            nd.rmspropalex_update(weight, grad, *state, gamma2=self.gamma2,
                                  **attrs)

    def pure_rule(self):
        """The ops' math (``ops/optimizer_ops.py``) with lr and wd as
        tensors, in place."""
        from .ops import optimizer_ops as ops

        g1, g2, eps = self.gamma1, self.gamma2, self.epsilon
        rescale, clip = self.rescale_grad, self._clip_attr()
        cw, centered = self._clip_weights_attr(), self.centered

        def rule(w, g, s, lr, wd):
            if centered:
                ops.rmspropalex(w, g, *s, lr, wd, rescale, clip, g1, g2,
                                eps, cw)
            else:
                ops.rmsprop(w, g, s[0], lr, wd, rescale, clip, g1, eps, cw)
            return w, s

        return rule


@register
class AdaDelta(Optimizer):
    """AdaDelta; it takes no learning rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        _adadelta_step(weight._data, g, state[0]._data, state[1]._data,
                       self._get_wd(index), self.rho, self.epsilon)

    def pure_rule(self):
        rho, eps, rescale, clip = (self.rho, self.epsilon, self.rescale_grad,
                                   self.clip_gradient)

        def rule(w, g, s, lr, wd):
            _adadelta_step(w, _scaled(g, rescale, clip, False), s[0], s[1],
                           wd, rho, eps)
            return w, s

        return rule


@register
class Ftrl(Optimizer):
    """FTRL-proximal on the weight's device (the JAX package computes the
    last step on the host)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = _scaled(grad._data, self.rescale_grad, self.clip_gradient, True)
        z, n = state[0]._data, state[1]._data
        sigma = -torch.sqrt(n)
        n.add_(g * g)
        sigma = (sigma + torch.sqrt(n)) / lr
        z.copy_(z + g - sigma * w)
        l1 = self.lamda1
        w.copy_(torch.where(
            z.abs() > l1,
            -(z - torch.sign(z) * l1) / ((self.beta + torch.sqrt(n)) / lr
                                         + wd),
            torch.zeros((), dtype=w.dtype, device=w.device)))


@register
class Test(Optimizer):
    """The reference's test optimizer: w += rescale * g, and the state a
    copy of the new weight. It counts no update, as the reference's."""

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        weight._data.add_(grad._data * self.rescale_grad)
        state._data.copy_(weight._data)


class Updater:
    """Applies an optimizer by integer index, creating each index's state
    on first use and again when a hyperparameter change changes its
    structure (reference optimizer.py get_updater, ``ensure_state``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}
        self._state_keys: Dict = {}
        # indices whose state set_states left on the host: moved to the
        # weight's device on first use
        self._on_host = set()

    def ensure_state(self, index, weight, key=None):
        """The state of ``index``, created on first use and created again
        when a hyperparameter change (``key``, :meth:`Optimizer.
        _hyperparam_key`) changes its structure."""
        if key is None:
            key = self.optimizer._hyperparam_key()
        if index in self._on_host:
            self._on_host.discard(index)
            self.states[index] = _state_to(self.states[index],
                                           weight.context)
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif self._state_keys.get(index) != key:
            fresh = self.optimizer.create_state(index, weight)
            if _state_structure(state_leaves(fresh)) != _state_structure(
                    state_leaves(self.states[index])):
                self.states[index] = fresh
        self._state_keys[index] = key
        return self.states[index]

    def __call__(self, index, grad: NDArray, weight: NDArray, key=None):
        self.ensure_state(index, weight, key)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_all(self, pairs):
        """Apply the optimizer to each (index, grad, weight) pair in turn."""
        key = self.optimizer._hyperparam_key()
        for index, grad, weight in pairs:
            self(index, grad, weight, key)

    def get_states(self):
        """The states as bytes: a pickle of {index: numpy array, tuple of
        them or None} plus ``__update_counts__``, the optimizer's count of
        each index (the JAX package's blob)."""
        def conv(v):
            if isinstance(v, tuple):
                return tuple(None if x is None else x.asnumpy() for x in v)
            return None if v is None else v.asnumpy()

        blob = {k: conv(v) for k, v in self.states.items()}
        blob["__update_counts__"] = dict(self.optimizer._index_update_count)
        return pickle.dumps(blob)

    def set_states(self, states):
        """Restore :meth:`get_states`' bytes (from either package): the
        counts, so a count-dependent rule (Adam's bias correction) goes on
        from its step, and the states, held on the host until their
        index's first use moves them to its weight's device."""
        blob = pickle.loads(states)
        counts = blob.pop("__update_counts__", None)
        if counts is not None:
            self.optimizer._index_update_count = dict(counts)
            if counts:
                self.optimizer.num_update = max(self.optimizer.num_update,
                                                max(counts.values()))

        def conv(v):
            if isinstance(v, tuple):
                return tuple(None if x is None else nd.array(x, ctx="cpu")
                             for x in v)
            return None if v is None else nd.array(v, ctx="cpu")

        self.states = {k: conv(v) for k, v in blob.items()}
        self._state_keys = {}
        self._on_host = set(self.states)


def _state_to(state, device):
    """An optimizer state (None, an NDArray or a tuple) on ``device``."""
    if isinstance(state, tuple):
        return tuple(_state_to(x, device) for x in state)
    if state is None or state.context == device:
        return state
    return NDArray(state._data.to(device))


class FusedUpdate:
    """The update of a fused training step over the parameters ``names``,
    each at its ``updater`` index in ``indices`` (default: its position).

    * Called, it is the step's ``update_fn(params, grads, states, lr_arr,
      wd_arr)``: the optimizer's ``pure_rule()`` on each parameter, with
      the (lr, wd) at the parameter's position in the two arrays.
    * :meth:`states` gives the updater's state tensors of the weights.
    * :meth:`lr_wd` counts one update of every index, as the ``Updater``
      does, and returns this step's (lr_arr, wd_arr) on a device.

    ``key`` is the optimizer's ``_hyperparam_key()`` that the rule fixed:
    whoever keeps a ``FusedUpdate`` builds it anew when the key changes."""

    def __init__(self, updater, names, indices=None):
        self.updater = updater
        self.optimizer = updater.optimizer
        self.names = list(names)
        self.indices = (list(range(len(self.names))) if indices is None
                        else list(indices))
        self.rule = self.optimizer.pure_rule()
        self.key = self.optimizer._hyperparam_key()
        self._cache = None

    def __call__(self, params, grads, states, lr_arr, wd_arr):
        new_p, new_s = {}, {}
        for pos, n in enumerate(self.names):
            new_p[n], new_s[n] = self.rule(params[n], grads[n], states[n],
                                           lr_arr[pos], wd_arr[pos])
        return new_p, new_s

    def states(self, weights):
        """name -> the state tensors of ``weights[name]`` (NDArrays),
        created as the ``Updater`` creates them."""
        return {n: state_leaves(self.updater.ensure_state(
            i, weights[n], key=self.key))
            for n, i in zip(self.names, self.indices)}

    def lr_wd(self, device):
        """Count this step's updates; (lr_arr, wd_arr) on ``device``,
        uploaded again only when a value changed."""
        opt = self.optimizer
        for i in self.indices:
            opt._update_count(i)
        lr_arr, wd_arr, self._cache = cached_lr_wd_arrays(
            self._cache, [opt.effective_lr_wd(i) for i in self.indices],
            device)
        return lr_arr, wd_arr


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
