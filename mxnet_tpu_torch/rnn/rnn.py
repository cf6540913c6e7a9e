"""RNN checkpoints (counterpart of ``mxnet_tpu/rnn/rnn.py``, reference
python/mxnet/rnn/rnn.py): the cells' weights are saved unpacked (a fused
blob as its per-gate arrays) and packed again on load, so a checkpoint
crosses between the fused and the unfused form."""
from __future__ import annotations

from .. import model as _model


def _each(cells, fn, params):
    for cell in cells if isinstance(cells, (list, tuple)) else [cells]:
        params = fn(cell, params)
    return params


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """``model.save_checkpoint`` with ``cells``' weights unpacked."""
    arg_params = _each(cells, lambda c, a: c.unpack_weights(a), arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint, ``cells``'
    weights packed."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    return sym, _each(cells, lambda c, a: c.pack_weights(a), arg), aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback: :func:`save_rnn_checkpoint` every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
