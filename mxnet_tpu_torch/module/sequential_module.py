"""``SequentialModule``: a chain of modules, each one's outputs the next
one's data.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (reference
python/mxnet/module/sequential_module.py). ``add(module, take_labels=...,
auto_wiring=...)`` appends a module: ``take_labels`` binds it with the
chain's labels and updates the metric from its outputs, ``auto_wiring``
renames the incoming shapes to its ``data_names``. Every module after the
first binds with ``inputs_need_grad`` when training, so ``backward`` runs
the chain in reverse, each module's input gradients the previous one's
output gradients. A graph module's output shapes come from its symbol's
shape inference, a ``PythonModule``'s from its ``output_shapes``. Each
module has its own optimizer and updater (``init_optimizer`` passes the
same arguments to each) and runs its unfused step.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from .base_module import BaseModule


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = {getattr(SequentialModule, x)
                           for x in dir(SequentialModule)
                           if x.startswith("META_")}

    def add(self, module, **kwargs):
        """Append ``module``; returns the chain (calls chain)."""
        for key in kwargs:
            if key not in self._meta_keys:
                raise ValueError("Unknown meta \"%s\", a typo?" % key)
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _takes_labels(self, i):
        return bool(self._metas[i].get(SequentialModule.META_TAKE_LABELS))

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._check_bound()
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._check_bound()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._check_bound()
        return self._modules[-1].output_shapes

    def _check_bound(self):
        if not self.binded:
            raise MXNetError("call bind first")

    def get_params(self):
        self._check_ready()
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Each module's, in order; a parameter name two modules share
        raises."""
        if self.params_initialized and not force_init:
            return
        self._check_bound()
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)
        for kind in (0, 1):
            owner = {}
            for i, module in enumerate(self._modules):
                for name in module.get_params()[kind]:
                    if name in owner:
                        raise MXNetError(
                            "Duplicated parameter names: name %s in layer "
                            "%d (%s) is already used in layer %d (%s)."
                            % (name, i, type(module).__name__, owner[name],
                               type(self._modules[owner[name]]).__name__))
                    owner[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise MXNetError("a SequentialModule cannot share a module")
        if not self._modules:
            raise MXNetError("Attempting to bind an empty SequentialModule")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        any_labels = False
        for i, module in enumerate(self._modules):
            my_label_shapes = None
            if self._takes_labels(i):
                my_label_shapes = label_shapes
                any_labels = True
            if self._metas[i].get(SequentialModule.META_AUTO_WIRING):
                names = module.data_names
                if len(names) != len(my_data_shapes):
                    raise MXNetError(
                        "auto_wiring: module %d takes %d inputs, the chain "
                        "gives %d" % (i, len(names), len(my_data_shapes)))
                my_data_shapes = [(name, _shape(d)) for name, d in
                                  zip(names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=bool(for_training and (
                            inputs_need_grad or i > 0)),
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = _output_shapes(module, my_data_shapes,
                                            my_label_shapes)
        if not any_labels:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check_ready()
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label, pad=data_batch.pad,
                              index=data_batch.index)

    def backward(self, out_grads=None):
        self._check_ready()
        for i in reversed(range(len(self._modules))):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        self._check_ready()
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._check_ready()
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check_ready()
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True for input "
                             "gradients")
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._check_ready()
        for i, module in enumerate(self._modules):
            if self._takes_labels(i):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._check_bound()
        for module in self._modules:
            module.install_monitor(mon)


def _shape(desc):
    return tuple(desc.shape) if hasattr(desc, "shape") else tuple(desc[1])


def _output_shapes(module, data_shapes, label_shapes):
    """[(name, shape)] of ``module``'s outputs once bound for these
    inputs: a graph module's from its symbol's shape inference, any other
    module's from its ``output_shapes``."""
    symbol = module.symbol
    if symbol is None:
        return [(getattr(d, "name", None) or d[0], _shape(d))
                for d in module.output_shapes]
    shapes = {getattr(d, "name", None) or d[0]: _shape(d)
              for d in list(data_shapes) + list(label_shapes or [])}
    _, out_shapes, _ = symbol.infer_shape_partial(**shapes)
    return [DataDesc(n, s) for n, s in zip(module.output_names, out_shapes)]
