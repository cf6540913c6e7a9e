"""``Module``: the concrete training module, on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
python/mxnet/module/module.py), its unfused path: ``bind`` builds the
executor group, ``init_params`` fills host copies of the parameters by
name (weight by the initializer; bias and beta 0, gamma 1, moving_mean 0,
moving_var 1) and copies them to the device, ``init_optimizer`` creates
the optimizer with ``rescale_grad = 1 / batch_size`` and its ``Updater``,
and ``update`` runs one updater call per parameter (the fused update
kernels). ``context=None`` is the first CUDA card; without one it raises.
``compute_dtype`` ("bfloat16") passes to the executor.

``fit_step`` (what ``fit`` calls each batch) is the reference's fused
step: forward, backward and the optimizer's ``pure_rule`` as one
``Executor.make_train_step``, which on the card is one CUDA graph
replayed each step (``MXNET_CUDA_GRAPH=0`` runs it eagerly). The step
updates the executor's parameters and the updater's states in place, so
``get_params``, ``set_params`` and a manual ``update`` see and reach the
same tensors. Per-parameter lr / wd go in as device arrays, uploaded again
when their contents change (a schedule, Adam's bias correction, an
in-place ``opt.lr_mult[name] = 2.0``). The reference's conditions apply
(``MXNET_FUSED_FIT``, no kvstore, a pure rule, no input gradients, every
parameter's ``grad_req`` "write"), and one of the port's: no Custom op
that copies to the host (a ``NumpyOp``). Otherwise ``fit_step`` runs
``forward_backward`` and ``update`` and :meth:`Module.fit_step_stats`
says why.

``bind(shared_module=...)`` (``BucketingModule``'s buckets) shares that
module's parameter and aux-state tensors and host copies; both must list
their parameters in the same order, the updater's index keys.
``borrow_optimizer`` shares its optimizer and updater. Checkpoints
(``save_checkpoint``, ``Module.load``, ``save_params`` / ``load_params``,
``save_optimizer_states`` / ``load_optimizer_states``) are the JAX
package's files: the symbol's JSON, an ``nd.save`` blob of ``arg:`` /
``aux:`` arrays and the ``Updater``'s state blob, written through the
engine (``async_write``). The fused step updates the executor's
parameters and the updater's states in place, so a save reads the
stepped values; loading optimizer states replaces the updater's tensors,
so it drops the fused step, which the next ``fit_step`` builds (and, on
the card, captures) anew. Kvstores and several contexts are not ported.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from .. import engine
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import cpu, resolve_device
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, _update_params, load_checkpoint
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, compute_dtype=None):
        super().__init__(logger=logger)
        self._compute_dtype = compute_dtype
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
        # the fused step's state: None not built yet, False ineligible
        self._fused_fit = None
        self._fused_reason = None
        # optimizer states init_optimizer loads (Module.load)
        self._preload_opt_states = None

    # --- checkpoints ------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint's symbol and parameters (reference
        module.py:115); with ``load_optimizer_states`` its
        ``init_optimizer`` loads ``prefix-%04d.states`` as well."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        async_write=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (reference
        module.py:135)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name, async_write=async_write)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name, async_write=async_write)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    def save_optimizer_states(self, fname, async_write=False):
        """The updater's state blob (``Updater.get_states``, taken now),
        written atomically through the engine."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        blob = self._updater.get_states()

        def write():
            with open(fname + ".tmp", "wb") as fout:
                fout.write(blob)
            os.replace(fname + ".tmp", fname)

        engine.push_file_write(fname, write, wait=not async_write,
                               name="save_optimizer_states")

    def load_optimizer_states(self, fname):
        """Restore the updater's states from a blob of either package. The
        fused step adopted the old state tensors, so it is dropped and
        built anew at the next ``fit_step``."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        engine.wait_for_file(fname)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._fused_fit = None

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer and updater (reference
        module.py borrow_optimizer; used by ``BucketingModule``)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("the shared module has no optimizer yet")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._fused_fit = None

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
        ((name, shape) pairs or ``DataDesc``) on the module's device; with
        ``shared_module`` (bound, initialized, the same parameter names in
        the same order) on its parameter and aux-state tensors."""
        if shared_module is not None:
            if not (shared_module.binded
                    and shared_module.params_initialized):
                raise MXNetError("bind and initialize the shared module "
                                 "first")
            if shared_module._param_names != self._param_names:
                raise MXNetError(
                    "the shared module lists its parameters as %s, this "
                    "one as %s: the updater's index keys would mix their "
                    "states" % (shared_module._param_names,
                                self._param_names))
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._fused_fit = None
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
            grad_req=grad_req, compute_dtype=self._compute_dtype,
            shared_group=(shared_module._exec_group
                          if shared_module is not None else None))
        self._fused_fit = None
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
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
        self._fused_fit = None
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

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

    # --- the fused step ---------------------------------------------------
    def fit_step(self, data_batch):
        """One training step: the fused step (forward, backward and update
        as one ``make_train_step``, one CUDA graph on the card) where the
        set-up allows it, else ``forward_backward`` + ``update``."""
        fs = self._fused_fit_state()
        if fs is None:
            self.forward_backward(data_batch)
            self.update()
            return
        exe, update = self._exec_group._exec, fs["update"]
        lr_arr, wd_arr = update.lr_wd(exe._device)
        self._exec_group._load_data(data_batch)
        # the executor's parameters and the updater's states, which the
        # step updates in place (the first call adopts them)
        params = {n: exe.arg_dict[n]._data for n in update.names}
        fs["step"](params, update.states(exe.arg_dict), None, lr_arr, wd_arr)
        self._params_dirty = True
        if not fs["host_checked"]:
            # the first step created the Custom operators: a NumpyOp reads
            # the host, which no captured step can hold
            fs["host_checked"] = True
            ops = exe._host_copy_ops()
            if ops:
                self._fused_ineligible(
                    "a Custom op copies to the host (%s)"
                    % ", ".join(sorted({type(o).__name__ for o in ops})))

    def fit_step_stats(self):
        """Which path ``fit_step`` takes: {"path": "captured" | "eager" |
        "unfused", ...}; the captured and eager paths add their step's
        counts (warm-up calls, captures, replays), the unfused one the
        reason."""
        if self._fused_fit:
            return dict(self._fused_fit["step"].stats(), **{
                "compute_dtype": str(self._exec_group._exec.compute_dtype
                                     or "float32").replace("torch.", "")})
        return {"path": "unfused", "reason": self._fused_reason}

    def _fused_ineligible(self, reason):
        self._fused_fit = False
        self._fused_reason = reason

    def _fused_fit_state(self):
        """The fused step's state, built on first use; None where the
        set-up does not allow it (the reason kept)."""
        if self._fused_fit is not None:
            if self._fused_fit and self._fused_fit["update"].key != \
                    self._optimizer._hyperparam_key():
                # a hyperparameter the rule fixes changed: build anew
                self._fused_fit = None
            else:
                return self._fused_fit or None
        exe = self._exec_group._exec if self._exec_group else None
        names = list(self._exec_group.param_names) if exe else []
        reason = None
        if os.environ.get("MXNET_FUSED_FIT", "1") == "0":
            reason = "MXNET_FUSED_FIT=0"
        elif not self.optimizer_initialized:
            reason = "no optimizer"
        elif self._kvstore is not None or self._update_on_kvstore:
            reason = "a kvstore"
        elif self._optimizer.pure_rule() is None:
            reason = "%s has no pure rule" % type(self._optimizer).__name__
        elif self.inputs_need_grad:
            reason = "inputs_need_grad"
        elif any(exe.grad_req.get(n) != "write" for n in names):
            reason = "a parameter's grad_req is not write"
        elif exe._host_copy_ops():
            reason = "a Custom op copies to the host"
        if reason is not None:
            self._fused_ineligible(reason)
            return None
        # the unfused path's state keys (model.py _update_params)
        update = opt.FusedUpdate(self._updater, names, [
            i * len(self._context) for i in range(len(names))])
        self._fused_fit = {"step": exe.make_train_step(update),
                           "update": update, "host_checked": False}
        self._fused_reason = None
        return self._fused_fit

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
