"""Modules written in Python, without a symbolic graph.

Counterpart of ``mxnet_tpu/module/python_module.py`` (reference
python/mxnet/module/python_module.py). ``PythonModule`` holds no
parameters and does nothing to update; a subclass computes its outputs
(``_compute_output_shapes``, ``forward``, ``backward``).
``PythonLossModule`` is a loss head for ``SequentialModule``: its output
is its input (the scores), and ``backward`` makes the input gradient with
``grad_func(scores, labels)``, on the scores' device.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..base import MXNetError
from .base_module import BaseModule


class PythonModule(BaseModule):
    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if grad_req != "write":
            raise MXNetError("a PythonModule takes grad_req 'write' only")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss: outputs its scores; the input gradient is
    ``grad_func(scores, labels)`` (an NDArray, or anything ``nd.array``
    takes)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        if len(self._data_names) != 1 or len(self._label_names) != 1:
            raise MXNetError("a PythonLossModule takes one data and one "
                             "label")
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        d = self._data_shapes[0]
        shape = d.shape if hasattr(d, "shape") else d[1]
        return [(self._name + "_output", tuple(shape))]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0] if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("a loss module takes no out_grads")
        if not self.for_training:
            raise MXNetError("bind with for_training=True to run backward")
        if self._grad_func is None:
            raise NotImplementedError("PythonLossModule needs a grad_func")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
