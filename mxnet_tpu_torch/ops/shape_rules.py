"""Parameter-shape rules: given the data shape and the attributes, the
shapes of an op's parameters, so ``simple_bind`` can size the weights from
the data shape alone.

Counterpart of ``mxnet_tpu/ops/shape_rules.py`` for the ported layer ops.
Each rule: fn(attrs, shapes) -> shapes, where ``shapes`` is ordered
arg_names + aux_names and holds None where a shape is unknown.
"""
from __future__ import annotations

import numpy as np

from .registry import get_op


def _fc_infer(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    num_hidden = int(attrs["num_hidden"])
    in_dim = int(np.prod(data[1:])) if attrs["flatten"] else data[-1]
    shapes[1] = shapes[1] or (num_hidden, in_dim)
    if not attrs["no_bias"] and len(shapes) > 2:
        shapes[2] = shapes[2] or (num_hidden,)
    return shapes


def _conv_infer(attrs, shapes):
    data = shapes[0]
    if data is None:
        return shapes
    kernel = tuple(int(k) for k in attrs["kernel"])
    nf = int(attrs["num_filter"])
    shapes[1] = shapes[1] or (nf, data[1] // int(attrs["num_group"])) + kernel
    if not attrs["no_bias"] and len(shapes) > 2:
        shapes[2] = shapes[2] or (nf,)
    return shapes


def _bn_infer(attrs, shapes):
    """gamma, beta and both aux states are (C,), C on ``axis``."""
    data = shapes[0]
    if data is None:
        return shapes
    c = (data[int(attrs["axis"]) % len(data)],)
    for i in range(1, len(shapes)):
        shapes[i] = shapes[i] or c
    return shapes


def _embedding_infer(attrs, shapes):
    shapes[1] = shapes[1] or (int(attrs["input_dim"]),
                              int(attrs["output_dim"]))
    return shapes


def _softmax_output_infer(attrs, shapes):
    data = shapes[0]
    if data is None or len(shapes) < 2:
        return shapes
    if attrs["multi_output"]:
        label = (data[0],) + tuple(data[2:])
    elif attrs["preserve_shape"]:
        label = tuple(data[:-1])
    else:
        label = (data[0],)
    shapes[1] = shapes[1] or label
    return shapes


def install():
    get_op("FullyConnected").infer_params = _fc_infer
    get_op("Convolution").infer_params = _conv_infer
    get_op("BatchNorm").infer_params = _bn_infer
    get_op("Embedding").infer_params = _embedding_infer
    get_op("SoftmaxOutput").infer_params = _softmax_output_infer
