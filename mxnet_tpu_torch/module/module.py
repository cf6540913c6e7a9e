"""``Module``: the concrete training module, on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
python/mxnet/module/module.py), its unfused path: ``bind`` builds the
executor group, ``init_params`` fills host copies of the parameters by
name (weight by the initializer; bias and beta 0, gamma 1, moving_mean 0,
moving_var 1) and copies them to the device, ``init_optimizer`` creates
the optimizer with ``rescale_grad = 1 / batch_size`` and its ``Updater``,
and ``update`` runs one updater call per parameter (the fused update
kernels). ``context=None`` is the first CUDA card; without one it raises.
The reference's fused ``fit_step`` (``Executor.make_train_step``),
``compute_dtype``, kvstores, several contexts, checkpoints and shared
modules are not ported.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu, resolve_device
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, _update_params
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        contexts = context if isinstance(context, (list, tuple)) \
            else [context]
        if len(contexts) != 1:
            raise MXNetError("a Module over %d contexts is not ported (one "
                             "device)" % len(contexts))
        self._context = [resolve_device(contexts[0])]
        del work_load_list  # one device: nothing to balance
        self._symbol = symbol
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        state_names = list(state_names or [])
        fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    # --- properties -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._check_bound()
        return self._data_shapes

    @property
    def label_shapes(self):
        self._check_bound()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._check_bound()
        outs = self._exec_group.get_outputs()
        return [(n, o.shape) for n, o in zip(self._output_names, outs)] \
            if outs else None

    def _check_bound(self):
        if not self.binded:
            raise MXNetError("call bind first")

    # --- parameters -------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): host NDArrays by name."""
        self._check_ready()
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill every parameter and aux state, in sorted name order, from
        ``arg_params`` / ``aux_params`` where given, else by
        ``initializer``; then copy them to the device."""
        if self.params_initialized and not force_init:
            return
        self._check_bound()
        exe = self._exec_group._exec
        if self._arg_params is None:
            self._arg_params = {n: nd.zeros(a.shape, cpu())
                                for n, a in exe.arg_dict.items()
                                if n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: nd.zeros(a.shape, cpu())
                                for n, a in exe.aux_dict.items()}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = cache[name]
                if src is arr:
                    return
                if tuple(src.shape) != tuple(arr.shape):
                    raise MXNetError("shape mismatch for %s: %s vs %s"
                                     % (name, src.shape, arr.shape))
                arr[:] = src if isinstance(src, nd.NDArray) \
                    else np.asarray(src)
                return
            if cache is not None and not allow_missing:
                raise MXNetError("%s is not presented" % name)
            if initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    # --- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group for ``data_shapes`` / ``label_shapes``
        ((name, shape) pairs or ``DataDesc``) on the module's device."""
        if shared_module is not None:
            raise MXNetError("shared modules are not ported")
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training and inputs_need_grad:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [x if hasattr(x, "name") else DataDesc(*x)
                             for x in data_shapes]
        self._label_shapes = None if label_shapes is None else [
            x if hasattr(x, "name") else DataDesc(*x) for x in label_shapes]
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        self.binded = True
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (by name, with ``rescale_grad`` 1 / batch
        size unless given) and its updater."""
        self._check_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad",
                              1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self.symbol,
                param_idx2name=dict(enumerate(self._exec_group.param_names)),
                **params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    # --- computations -----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._check_ready()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._check_ready()
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter with a gradient."""
        self._check_ready()
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        self._params_dirty = True
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=len(self._context), kvstore=self._kvstore)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        self._check_ready()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check_ready()
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True for input "
                             "gradients")
        return self._exec_group.get_input_grads(merge_multi_context)
