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


def _deconv_infer(attrs, shapes):
    """Deconvolution's weight is (C_in, num_filter / num_group) + kernel;
    its bias (num_filter,) where ``no_bias`` is off."""
    data = shapes[0]
    if data is None:
        return shapes
    kernel = tuple(int(k) for k in attrs["kernel"])
    nf = int(attrs["num_filter"])
    shapes[1] = shapes[1] or (data[1], nf // int(attrs["num_group"])) \
        + kernel
    if not attrs["no_bias"] and len(shapes) > 2:
        shapes[2] = shapes[2] or (nf,)
    return shapes


def _bn_infer(attrs, shapes):
    """Every other input and aux state is (C,), C on ``axis`` (1 for the
    ops without one: InstanceNorm, IdentityAttachKLSparseReg)."""
    data = shapes[0]
    if data is None:
        return shapes
    c = (data[int(attrs.get("axis", 1)) % len(data)],)
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


def _prelu_infer(attrs, shapes):
    """prelu's gamma: one slope a channel (axis 1)."""
    data = shapes[0]
    if data is None or len(shapes) < 2:
        return shapes
    shapes[1] = shapes[1] or (data[1] if len(data) > 1 else 1,)
    return shapes


def _upsampling_infer(attrs, shapes):
    """Bilinear UpSampling's weight: (C, 1, k, k), k = 2 s - s % 2."""
    data = shapes[0]
    if attrs["sample_type"] == "bilinear" and data is not None \
            and len(shapes) > 1:
        s = int(attrs["scale"])
        k = 2 * s - s % 2
        shapes[1] = shapes[1] or (data[1], 1, k, k)
    return shapes


def _regression_infer(attrs, shapes):
    """A regression head's label has the output's shape."""
    if shapes[0] is not None and len(shapes) > 1:
        shapes[1] = shapes[1] or tuple(shapes[0])
    return shapes


def _label_vec_infer(attrs, shapes):
    """One label a sample: (N,)."""
    if shapes[0] is not None and len(shapes) > 1:
        shapes[1] = shapes[1] or (shapes[0][0],)
    return shapes


def install():
    get_op("FullyConnected").infer_params = _fc_infer
    get_op("Convolution").infer_params = _conv_infer
    get_op("BatchNorm").infer_params = _bn_infer
    get_op("Embedding").infer_params = _embedding_infer
    get_op("SoftmaxOutput").infer_params = _softmax_output_infer
    for name in ("LinearRegressionOutput", "MAERegressionOutput",
                 "LogisticRegressionOutput"):
        get_op(name).infer_params = _regression_infer
    get_op("SVMOutput").infer_params = _label_vec_infer
    get_op("softmax_cross_entropy").infer_params = _label_vec_infer
    get_op("Deconvolution").infer_params = _deconv_infer
    get_op("InstanceNorm").infer_params = _bn_infer
    get_op("IdentityAttachKLSparseReg").infer_params = _bn_infer
    get_op("LeakyReLU").infer_params = _prelu_infer
    get_op("UpSampling").infer_params = _upsampling_infer
