"""Sequence operators and the binary cross-entropy loss.

Counterpart of ``mxnet_tpu/ops/sequence.py`` (reference src/operator/
sequence_{mask,last,reverse}.cc and tensor/loss_binary_op.cc). Layout is
time-major, ``(max_len, batch, ...)``, unless ``axis`` says otherwise;
``sequence_length`` is a ``(batch,)`` vector of valid lengths (any numeric
type, truncated to integers where it indexes) and takes no gradient.

Where the JAX package departs from MXNet, this follows the JAX package:
``SequenceReverse`` ignores ``axis`` (it always reverses axis 0), and a
length of 0 makes ``SequenceLast`` pick step 0.
"""
from __future__ import annotations

import torch

from .registry import defop


def _seq_args(attrs):
    return (("data", "sequence_length") if attrs.get("use_sequence_length")
            else ("data",))


def _len_mask(seq_len, max_len, dtype):
    """(max_len, batch) of 1 where the step lies inside its sequence."""
    steps = torch.arange(max_len, dtype=torch.float32,
                         device=seq_len.device).reshape(max_len, 1)
    return (steps < seq_len.to(torch.float32).reshape(1, -1)).to(dtype)


@defop("SequenceMask", arg_names=_seq_args,
       param_spec={"use_sequence_length": False, "value": 0.0, "axis": 0},
       no_grad_inputs=("sequence_length",))
def _sequence_mask(attrs, data, sequence_length=None):
    """Positions past each sequence's length set to ``value``."""
    if sequence_length is None:
        return data
    ax = int(attrs["axis"])
    x = torch.movedim(data, ax, 0) if ax != 0 else data
    t = x.shape[0]
    mask = _len_mask(sequence_length, t, x.dtype).reshape(
        (t, x.shape[1]) + (1,) * (x.dim() - 2))
    out = x * mask + attrs["value"] * (1 - mask)
    return torch.movedim(out, 0, ax) if ax != 0 else out


@defop("SequenceLast", arg_names=_seq_args,
       param_spec={"use_sequence_length": False, "axis": 0},
       no_grad_inputs=("sequence_length",))
def _sequence_last(attrs, data, sequence_length=None):
    """The last valid step of each sequence."""
    ax = int(attrs["axis"])
    x = torch.movedim(data, ax, 0) if ax != 0 else data
    if sequence_length is None:
        return x[-1]
    idx = torch.clamp(sequence_length.to(torch.int64) - 1, min=0)
    return x[idx, torch.arange(x.shape[1], device=x.device)]


@defop("SequenceReverse", arg_names=_seq_args,
       param_spec={"use_sequence_length": False, "axis": 0},
       no_grad_inputs=("sequence_length",))
def _sequence_reverse(attrs, data, sequence_length=None):
    """Each sequence's valid prefix reversed, the padding left in place."""
    if sequence_length is None:
        return torch.flip(data, dims=(0,))
    t = data.shape[0]
    steps = torch.arange(t, device=data.device).reshape(t, 1)
    length = sequence_length.to(torch.int64).reshape(1, -1)
    src = torch.where(steps < length, length - 1 - steps, steps)  # (t, b)
    idx = src.reshape(src.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return torch.gather(data, 0, idx)


@defop("softmax_cross_entropy", arg_names=("data", "label"), param_spec={},
       no_grad_inputs=("label",))
def _softmax_cross_entropy(attrs, data, label):
    """The summed cross-entropy of ``softmax(data)`` at ``label``: a
    scalar."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, 1, label.to(torch.int64).reshape(-1, 1))
    return -torch.sum(picked)
