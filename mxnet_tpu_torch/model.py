"""Model helpers that ``Module`` calls.

Counterpart of the part of ``mxnet_tpu/model.py`` (reference
python/mxnet/model.py) the training path uses: ``BatchEndParam``,
the kvstore policy ``_create_kvstore`` and the update on the workers
``_update_params``, and the checkpoints ``save_checkpoint`` /
``load_checkpoint`` (the symbol's JSON and an ``nd.save`` blob of
``arg:`` / ``aux:`` arrays, readable by the JAX package), and the legacy
estimator ``FeedForward`` over ``Module``; with the kvstore helpers
``_initialize_kvstore`` and ``_update_params_on_kvstore`` (the update on
the kvstore).

Telemetry (domain ``executor``): the update runs inside a
``model.update_params`` span (``model.update_params_on_kvstore`` when the
kvstore updates), and a checkpoint's host snapshot inside
``model.checkpoint_snapshot`` (the blob's write is an engine op with a
span of its own).
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np

from . import engine
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym_mod
from . import telemetry
from .base import MXNetError

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


#: a ``local`` kvstore updates on the workers (``update_on_kvstore``
#: False) when a parameter has more elements than this (reference
#: model.py:55-60)
BIG_PARAM_ELEMENTS = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for ``kvstore`` over ``num_device``
    devices (reference model.py:40-66): None, or one device with a name
    that is not ``dist_*``, needs none; a ``local`` store with a parameter
    of more than 16 M elements leaves the update to the workers."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values())
                if max_size > BIG_PARAM_ELEMENTS:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init each parameter's key (its index) from ``arg_params``; with
    the update on the kvstore, pull it into every context's array
    (reference model.py:68-86)."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push each parameter's gradients (one a context) and pull its
    updated weight into every context (reference model.py:88-97)."""
    with telemetry.span("model.update_params_on_kvstore",
                        domain="executor", n_params=len(param_arrays)):
        for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                          grad_arrays)):
            if grad_list[0] is None:
                continue
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """The update on the workers (reference model.py:99-122). Over several
    contexts the gradients are summed first (through ``kvstore``: push,
    then pull into every context's gradient; without one, on the first
    context), the first context's weight is updated at index ``i *
    num_device`` (the JAX package's key: one slot of its mesh executor,
    so optimizer-state files cross between the packages) and copied to
    the others, which therefore stay equal bit for bit. Parameters
    without a gradient array (fixed) are skipped."""
    with telemetry.span("model.update_params", domain="executor",
                        n_params=len(param_arrays)):
        pairs, copies = [], []
        for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                          grad_arrays)):
            if grad_list[0] is None:
                continue
            grad = grad_list[0]
            if kvstore is not None:
                kvstore.push(index, grad_list, priority=-index)
                kvstore.pull(index, grad_list, priority=-index)
            elif len(grad_list) > 1:
                grad = kvs._reduce(grad_list)
            pairs.append((index * num_device, grad, arg_list[0]))
            copies.append(arg_list)
        updater.update_all(pairs)
        for arg_list in copies:
            for w in arg_list[1:]:
                w._data.copy_(arg_list[0]._data)


def split_param_dict(save_dict, fname="params"):
    """(arg_params, aux_params) of a loaded ``arg:`` / ``aux:`` dict."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("Invalid param file " + fname)
    return arg_params, aux_params


def _snapshot(arg_params, aux_params):
    """The ``arg:`` / ``aux:`` dict of host copies of the arrays."""
    return {"%s:%s" % (kind, k): nd.NDArray(
        v._data.detach().to("cpu", copy=True))
        for kind, params in (("arg", arg_params), ("aux", aux_params))
        for k, v in params.items()}


def write_params(fname, arg_params, aux_params, async_write=False,
                 name="checkpoint_write", save_dict=None):
    """Write ``fname`` as ``nd.save`` of the ``arg:`` / ``aux:`` dict,
    atomically (a temporary file, then ``os.replace``), through
    ``engine.push_file_write``. The arrays are copied to the host first
    (or ``save_dict`` holds those copies), so an asynchronous write holds
    the values of the call."""
    if save_dict is None:
        save_dict = _snapshot(arg_params, aux_params)

    def _write():
        nd.save(fname + ".tmp", save_dict)
        os.replace(fname + ".tmp", fname)

    engine.push_file_write(fname, _write, wait=not async_write, name=name)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    async_write=False):
    """``prefix-symbol.json`` and ``prefix-%04d.params`` (reference
    model.py:319-347); ``async_write=True`` returns once the arrays are
    on the host and writes the blob behind training."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    with telemetry.span("model.checkpoint_snapshot", domain="executor",
                        epoch=epoch, n_params=len(arg_params)):
        save_dict = _snapshot(arg_params, aux_params)
    write_params(param_name, arg_params, aux_params, async_write,
                 save_dict=save_dict)
    logging.info("Saved checkpoint to \"%s\"%s", param_name,
                 " (async)" if async_write else "")


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint (reference
    model.py:349-384), the arrays on the host; waits for a write still in
    flight."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    param_name = "%s-%04d.params" % (prefix, epoch)
    engine.wait_for_file(param_name)
    arg_params, aux_params = split_param_dict(nd.load(param_name),
                                              param_name)
    return symbol, arg_params, aux_params


class FeedForward:
    """The reference's legacy estimator (reference model.py:387), over a
    ``Module``: ``fit`` trains ``symbol`` on numpy arrays or a data
    iterator with ``optimizer`` and the optimizer's keyword arguments,
    ``predict`` and ``score`` evaluate, ``save`` / ``load`` are
    ``save_checkpoint`` / ``load_checkpoint``. ``ctx`` None is the first
    CUDA card; over a list of contexts ``fit`` trains data-parallel
    through its ``kvstore``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, list) else [ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = dict(kwargs)
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward of a checkpoint's symbol and parameters."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    def _init_module(self, data):
        from .module import Module

        def names(descs):
            return [getattr(d, "name", None) or d[0] for d in descs or []]

        self._module = Module(self.symbol,
                              data_names=names(data.provide_data),
                              label_names=names(data.provide_label),
                              context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._prepare_data(X, y)
        self._init_module(data)
        opt_params = dict(self.kwargs)
        opt_params.setdefault("learning_rate", 0.01)
        self._module.fit(
            data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=opt_params,
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params, begin_epoch=self.begin_epoch,
            num_epoch=self.num_epoch, monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()

    def _bound_module(self, data):
        """The module, bound for inference on ``data`` if there is none
        yet."""
        if self._module is None or not self._module.binded:
            self._init_module(data)
            self._module.bind(data.provide_data, data.provide_label,
                              for_training=False)
            self._module.init_params(arg_params=self.arg_params,
                                     aux_params=self.aux_params)
        return self._module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy arrays (one, or a list)."""
        data = self._prepare_data(X)
        outs = self._bound_module(data).predict(data, num_batch=num_batch,
                                                reset=reset)
        if isinstance(outs, list):
            return [o.asnumpy() for o in outs]
        return outs.asnumpy()

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              reset=True):
        """The first value of ``eval_metric`` over ``X``."""
        data = self._prepare_data(X, y)
        res = self._bound_module(data).score(data, eval_metric,
                                             num_batch=num_batch, reset=reset)
        return res[0][1]

    def _prepare_data(self, X, y=None):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                np.asarray(X).shape[0]))
