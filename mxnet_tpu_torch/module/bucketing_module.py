"""``BucketingModule``: training over variable-length sequences.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (reference
python/mxnet/module/bucketing_module.py). ``sym_gen(bucket_key)`` returns
(symbol, data_names, label_names) for a bucket; each bucket is a
``Module`` bound with ``shared_module`` = the default bucket's, so every
bucket's executor runs on the same parameter and aux-state tensors and
only its data, label and gradient arrays are its own, and every bucket
borrows the default bucket's optimizer and updater. ``fit_step`` is the
base one (``forward_backward`` + ``update``), as in the JAX package: no
bucket's step is captured as a CUDA graph.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, compute_dtype=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._compute_dtype = compute_dtype
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _require(self, binded=True, params=True, optimizer=False):
        if (binded and not self.binded) or \
                (params and not self.params_initialized) or \
                (optimizer and not self.optimizer_initialized):
            raise MXNetError("BucketingModule: bind, init_params%s first"
                             % (" and init_optimizer" if optimizer else ""))

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require(params=False)
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._require(params=False)
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._require(params=False)
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._require(params=False)
        return self._curr_module.symbol

    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names,
                      compute_dtype=self._compute_dtype)

    # --- parameters -------------------------------------------------------
    def get_params(self):
        self._require()
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        self._require()
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
        self._params_dirty = False

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._require(params=False)
        from ..initializer import Uniform

        self._curr_module.init_params(
            initializer=(initializer if initializer is not None
                         else Uniform(0.01)),
            arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    # --- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (reference bucketing_module.py:168)."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it on the default
        bucket's parameters at first use (reference
        bucketing_module.py:233)."""
        self._require(params=False)
        if bucket_key not in self._buckets:
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[
                            self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # --- computations -----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require()
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._require()
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._require(optimizer=True)
        self._params_dirty = True
        if not self._curr_module.optimizer_initialized:
            # a bucket bound after init_optimizer borrows it now
            self._curr_module.borrow_optimizer(
                self._buckets[self._default_bucket_key])
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require()
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require()
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True for input "
                             "gradients")
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require()
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install ``mon`` on every bucket's module bound so far."""
        self._require(params=False)
        for mod in self._buckets.values():
            mod.install_monitor(mon)
