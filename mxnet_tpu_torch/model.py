"""Model helpers that ``Module`` calls.

Counterpart of the part of ``mxnet_tpu/model.py`` (reference
python/mxnet/model.py) the one-device training path uses: ``BatchEndParam``,
the kvstore policy ``_create_kvstore`` and the local update
``_update_params``, and the checkpoints ``save_checkpoint`` /
``load_checkpoint`` (the symbol's JSON and an ``nd.save`` blob of
``arg:`` / ``aux:`` arrays, readable by the JAX package). kvstores and
``FeedForward`` are not ported: a kvstore that would exist raises.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

from . import engine
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for ``kvstore`` over ``num_device``
    devices (reference model.py:40-66). One device and a non-``dist``
    name, or None, need no kvstore: (None, False). Every other case would
    create one, and kvstores are not ported, so it raises."""
    del arg_params
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return (None, False)
    raise MXNetError("kvstore %r over %d device(s) is not ported"
                     % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """The local update (reference model.py:99-122): one ``updater`` call
    per parameter and device, index ``i * num_device + k``; parameters
    without a gradient array (fixed) are skipped."""
    if kvstore is not None:
        raise MXNetError("updates through a kvstore are not ported")
    pairs = []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            pairs.append((index * num_device + k, g, w))
    updater.update_all(pairs)


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


def write_params(fname, arg_params, aux_params, async_write=False,
                 name="checkpoint_write"):
    """Write ``fname`` as ``nd.save`` of the ``arg:`` / ``aux:`` dict,
    atomically (a temporary file, then ``os.replace``), through
    ``engine.push_file_write``. The arrays are copied to the host first,
    so an asynchronous write holds the values of the call."""
    save_dict = {"%s:%s" % (kind, k): nd.NDArray(
        v._data.detach().to("cpu", copy=True))
        for kind, params in (("arg", arg_params), ("aux", aux_params))
        for k, v in params.items()}

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
    write_params(param_name, arg_params, aux_params, async_write)
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
