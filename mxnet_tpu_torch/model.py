"""Model helpers that ``Module`` calls.

Counterpart of the part of ``mxnet_tpu/model.py`` (reference
python/mxnet/model.py) the one-device training path uses: ``BatchEndParam``,
the kvstore policy ``_create_kvstore`` and the local update
``_update_params``. kvstores, checkpoints and ``FeedForward`` are not
ported: a kvstore that would exist raises.
"""
from __future__ import annotations

from collections import namedtuple

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
