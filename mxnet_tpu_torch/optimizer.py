"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference python/mxnet/
optimizer.py) for SGD (with and without momentum) and Adam: the registry,
the ``Optimizer`` base with lr / wd multipliers (no weight decay by default
for ``_bias`` / ``_gamma`` / ``_beta``), ``rescale_grad``,
``clip_gradient`` and an ``lr_scheduler`` hook, and the ``Updater`` a
training loop calls per parameter. The updates run the registry ops
``sgd_update`` / ``sgd_mom_update`` / ``adam_update``; the last two are the
fused CUDA kernels, which update the weight and the state in place. The
reference's whole-tree jitted ``update_all`` has no counterpart: here
``update_all`` loops, one kernel launch per parameter. The rest of the
reference's zoo (NAG, SGLD, AdaGrad, RMSProp, ...) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict

from . import ndarray as nd
from . import registry
from .ndarray import NDArray


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

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        nd.adam_update(weight, grad, mean, var, lr=lr,
                       wd=self._get_wd(index), beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon,
                       rescale_grad=self.rescale_grad,
                       clip_gradient=self._clip_attr())


class Updater:
    """Applies an optimizer by integer index, creating each index's state
    on first use (reference optimizer.py get_updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}

    def __call__(self, index, grad: NDArray, weight: NDArray):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_all(self, pairs):
        """Apply the optimizer to each (index, grad, weight) pair in turn."""
        for index, grad, weight in pairs:
            self(index, grad, weight)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
