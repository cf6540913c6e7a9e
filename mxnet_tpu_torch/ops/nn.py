"""Neural-network layer operators.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` the ported paths use
(reference src/operator/*): ``FullyConnected``, ``Convolution``,
``Pooling``, ``BatchNorm``, ``Activation``, ``Dropout``, the softmax
family, and the loss heads ``SoftmaxOutput`` and ``MakeLoss``. The loss heads keep the
reference's backward semantics, which ignore the incoming head gradient;
each is a ``torch.autograd.Function`` (the reference's ``jax.custom_vjp``).
The 2-D 3x3 convolution's weight gradient is the ``conv_wgrad`` kernel
(``kernels/conv_wgrad.py``); the reference's NHWC layout islands
(``ops/layout.py``) and its space-to-depth stem are not ported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from .kernels.conv_wgrad import wgrad
from .registry import REQUIRED, alias, defop


def _ntuple(v, n):
    """An attribute as an n-tuple of ints (a scalar repeats; empty is 1s)."""
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


# --- Dropout -----------------------------------------------------------------
@defop("Dropout", param_spec={"p": 0.5, "mode": "training"}, needs_rng=True,
       simple=False)
def _dropout(attrs, inputs, aux, ctx):
    """Inverted dropout (reference dropout-inl.h): in training (or always,
    with ``mode="always"``) ``x * mask / (1 - p)``, the mask drawn from
    the device's generator (``random.keep_mask``), so a kept entry is
    exactly ``x / (1 - p)`` and the gradient is ``dy / (1 - p)`` there, 0
    elsewhere; otherwise the identity."""
    (data,) = inputs
    p = float(attrs["p"])
    if p <= 0.0 or not (ctx.is_train or attrs["mode"] == "always") or \
            data.device.type == "meta":  # shape inference draws nothing
        return (data,), ()
    keep = 1.0 - p
    mask = _random.keep_mask(data.shape, keep, ctx.rng, data.device,
                             data.dtype)
    return (data * mask / keep,), ()


# --- FullyConnected ----------------------------------------------------------
@defop("FullyConnected",
       arg_names=lambda attrs: (("data", "weight") if attrs.get("no_bias")
                                else ("data", "weight", "bias")),
       param_spec={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(attrs, data, weight, bias=None):
    """out = data @ W.T + b; ``flatten`` collapses all but the first axis
    first, else the product runs over the last axis (reference
    fully_connected-inl.h:76-86)."""
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


# --- Convolution -------------------------------------------------------------
_CONV_SPEC = {"kernel": REQUIRED, "stride": (), "dilate": (), "pad": (),
              "num_filter": 0, "num_group": 1, "workspace": 1024,
              "no_bias": False, "cudnn_tune": None, "cudnn_off": False,
              "layout": None}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class _Conv2dWgrad(torch.autograd.Function):
    """2-D convolution with a square window, one stride and one pad on both
    axes: forward ``F.conv2d``; backward dX by
    ``torch.nn.grad.conv2d_input`` (only when the data needs it) and dW by
    the ``conv_wgrad`` kernel on the NHWC views of the data and dY, in
    their own type (the reference's f32 weight gradient is f32)."""

    @staticmethod
    def forward(ctx, data, weight, stride, pad):
        ctx.save_for_backward(data, weight)
        ctx.stride, ctx.pad = stride, pad
        return F.conv2d(data, weight, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, dy):
        data, weight = ctx.saved_tensors
        ddata = dweight = None
        if ctx.needs_input_grad[0]:
            ddata = torch.nn.grad.conv2d_input(
                data.shape, weight, dy, stride=ctx.stride, padding=ctx.pad)
        if ctx.needs_input_grad[1]:
            hwio = wgrad(data.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1),
                         weight.shape[2], ctx.stride, ctx.pad)
            dweight = hwio.permute(3, 2, 0, 1).to(weight.dtype)
        return ddata, dweight, None, None


@defop("Convolution",
       arg_names=lambda attrs: (("data", "weight") if attrs.get("no_bias")
                                else ("data", "weight", "bias")),
       param_spec=_CONV_SPEC)
def _convolution(attrs, data, weight, bias=None):
    """N-d convolution, data NC+spatial, weight OI+spatial (reference
    convolution-inl.h:90-288). 3x3 windows with dilation 1, one group and
    equal strides and pads on both axes take their weight gradient from
    the ``conv_wgrad`` kernel; every other window stays on autograd, as
    the reference leaves it to XLA."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    n = len(kernel)
    if attrs["layout"] not in (None, "NCW", "NCHW", "NCDHW"):
        raise MXNetError("Convolution layout %r is not ported (NC+spatial "
                         "only)" % (attrs["layout"],))
    stride = _ntuple(attrs["stride"], n)
    dilate = _ntuple(attrs["dilate"], n)
    pad = _ntuple(attrs["pad"], n) if attrs["pad"] else (0,) * n
    groups = int(attrs["num_group"])
    if (kernel == (3, 3) and dilate == (1, 1) and groups == 1
            and stride[0] == stride[1] and pad[0] == pad[1]):
        out = _Conv2dWgrad.apply(data, weight, stride[0], pad[0])
    else:
        out = _CONV[n](data, weight, stride=stride, padding=pad,
                       dilation=dilate, groups=groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


alias("Convolution", "Convolution_v1")


# --- Pooling -----------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@defop("Pooling", arg_names=("data",),
       param_spec={"kernel": (), "pool_type": "max", "global_pool": False,
                   "stride": (), "pad": (), "pooling_convention": "valid",
                   "cudnn_off": False})
def _pooling(attrs, data):
    """max / avg / sum pooling (reference pooling-inl.h). Padding is
    explicit: -inf for max, 0 otherwise, and avg divides by the full window
    (padding included). ``pooling_convention="full"`` adds the reference's
    extra high-side pad so the output size rounds up (not ``ceil_mode``,
    whose last window differs)."""
    ptype = attrs["pool_type"]
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % ptype)
    nsp = data.dim() - 2
    if attrs["global_pool"]:
        axes = tuple(range(2, data.dim()))
        if ptype == "max":
            return data.amax(dim=axes, keepdim=True)
        if ptype == "sum":
            return data.sum(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = tuple(int(k) for k in attrs["kernel"])
    stride = _ntuple(attrs["stride"], nsp)
    pad = _ntuple(attrs["pad"], nsp) if attrs["pad"] else (0,) * nsp
    flat = []  # F.pad order: last axis first, (low, high) each
    for i in reversed(range(nsp)):
        hi = pad[i]
        if attrs["pooling_convention"] == "full":
            size = data.shape[2 + i] + 2 * pad[i] - kernel[i]
            out_i = -(-size // stride[i]) + 1
            hi += max(0, (out_i - 1) * stride[i] + kernel[i]
                      - (data.shape[2 + i] + 2 * pad[i]))
        flat += [pad[i], hi]
    if ptype == "max":
        xp = F.pad(data, flat, value=float("-inf"))
        return _MAX_POOL[nsp](xp, kernel, stride)
    avg = _AVG_POOL[nsp](F.pad(data, flat), kernel, stride)
    return avg * float(np.prod(kernel)) if ptype == "sum" else avg


alias("Pooling", "Pooling_v1")


# --- BatchNorm ---------------------------------------------------------------
@defop("BatchNorm", arg_names=("data", "gamma", "beta"),
       aux_names=("moving_mean", "moving_var"),
       param_spec={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                   "use_global_stats": False, "output_mean_var": False,
                   "axis": 1, "cudnn_off": False},
       num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
       simple=False)
def _batch_norm(attrs, inputs, aux, ctx):
    """Batch normalization with moving-average aux states (reference
    batch_norm-inl.h): in training the batch mean and the **biased** batch
    variance normalize, and moving = m * moving + (1 - m) * batch for both;
    otherwise (or with ``use_global_stats``) the moving statistics
    normalize and stay. ``fix_gamma`` pins gamma to 1 with zero gradient.
    Plain ops, differentiated through the batch statistics as the
    reference is: ``F.batch_norm`` would update the aux states with the
    unbiased variance, and its f32 backward on the CPU loses digits where
    the input gradient is a small residual of large terms."""
    data, gamma, beta = inputs
    moving_mean, moving_var = aux
    ax = int(attrs["axis"]) % data.dim()
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)  # a constant: no gradient reaches it
    if ctx.is_train and not attrs["use_global_stats"]:
        red = tuple(i for i in range(data.dim()) if i != ax)
        mean = data.mean(dim=red)
        centered = data - mean.reshape(bshape)
        var = (centered * centered).mean(dim=red)
        m = attrs["momentum"]
        aux_updates = (moving_mean * m + mean.detach() * (1 - m),
                       moving_var * m + var.detach() * (1 - m))
    else:
        mean, var = moving_mean, moving_var
        centered = data - mean.reshape(bshape)
        aux_updates = (moving_mean, moving_var)
    scale = torch.rsqrt(var + attrs["eps"]) * gamma
    out = centered * scale.reshape(bshape) + beta.reshape(bshape)
    if attrs["output_mean_var"]:
        return (out, mean, var), aux_updates
    return (out,), aux_updates


alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")


# --- Activation --------------------------------------------------------------
_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    # jax.nn.gelu's default: the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
}


@defop("Activation", arg_names=("data",), param_spec={"act_type": "relu"})
def _activation(attrs, data):
    """relu | sigmoid | tanh | softrelu | softsign | gelu | silu."""
    fn = _ACTIVATIONS.get(attrs["act_type"])
    if fn is None:
        raise MXNetError("unknown act_type %r" % attrs["act_type"])
    return fn(data)


# --- softmax family ----------------------------------------------------------
def _tempered(attrs, data):
    t = attrs["temperature"]
    return data / t if t else data


@defop("softmax", arg_names=("data",),
       param_spec={"axis": -1, "temperature": None})
def _softmax(attrs, data):
    return torch.softmax(_tempered(attrs, data), dim=int(attrs["axis"]))


@defop("log_softmax", arg_names=("data",),
       param_spec={"axis": -1, "temperature": None})
def _log_softmax(attrs, data):
    return torch.log_softmax(_tempered(attrs, data), dim=int(attrs["axis"]))


def _one_hot_like(label, k, dtype):
    """One-hot of float labels over a new last axis; ids outside [0, k)
    (the ignore label) give an all-zero row."""
    hit = label.long().unsqueeze(-1) == torch.arange(k, device=label.device)
    return hit.to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward (p - onehot(label)) * grad_scale with the
    reference's use_ignore and batch/valid/null normalization
    (softmax_output-inl.h), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        if attrs["multi_output"]:
            out = torch.softmax(data, dim=1)
        elif attrs["preserve_shape"]:
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out  # the head gradient is ignored, as in the reference
        out, lab = ctx.saved_tensors
        attrs = ctx.attrs
        if attrs["multi_output"]:
            # data (n, k, x...): label (n, x...) indexes axis 1
            oh = _one_hot_like(lab, out.shape[1], out.dtype).movedim(-1, 1)
        else:
            k = (out.shape[-1] if attrs["preserve_shape"]
                 else int(np.prod(out.shape[1:])))
            oh = _one_hot_like(lab.reshape(-1), k,
                               out.dtype).reshape(out.shape)
        grad = out - oh
        scale = attrs["grad_scale"]
        valid = None
        if attrs["use_ignore"]:
            mask = (lab != attrs["ignore_label"]).to(out.dtype)
            if attrs["multi_output"]:
                grad = grad * mask.unsqueeze(1)
            else:
                grad = grad * mask.reshape(
                    mask.shape + (1,) * (grad.dim() - mask.dim()))
            valid = mask.sum().clamp(min=1.0)
        if attrs["normalization"] == "batch":
            scale = scale / out.shape[0]
        elif attrs["normalization"] == "valid" and valid is not None:
            scale = scale / valid
        return grad * scale, None, None


@defop("SoftmaxOutput", arg_names=("data", "label"),
       param_spec={"grad_scale": 1.0, "ignore_label": -1.0,
                   "multi_output": False, "use_ignore": False,
                   "preserve_shape": False, "normalization": "null",
                   "out_grad": False},
       no_grad_inputs=("label",))
def _softmax_output(attrs, data, label):
    """Softmax whose backward injects (p - onehot(label)) * grad_scale."""
    return _SoftmaxOutput.apply(data, label, attrs)


alias("SoftmaxOutput", "Softmax")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward the constant grad_scale (÷ batch, or ÷
    the count of entries above valid_thresh), whatever the head gradient
    (make_loss-inl.h)."""

    @staticmethod
    def forward(ctx, data, attrs):
        ctx.attrs = attrs
        ctx.batch = data.shape[0] if data.dim() else 1
        ctx.save_for_backward(data if attrs["normalization"] == "valid"
                              else None)
        return data.clone()

    @staticmethod
    def backward(ctx, grad_out):
        attrs = ctx.attrs
        scale = attrs["grad_scale"]
        if attrs["normalization"] == "batch":
            scale = scale / ctx.batch
        grad = torch.full_like(grad_out, scale)
        if attrs["normalization"] == "valid":
            (data,) = ctx.saved_tensors
            valid = (data > attrs["valid_thresh"]).to(grad.dtype).sum()
            grad = grad / valid.clamp(min=1.0)
        return grad, None


@defop("MakeLoss", arg_names=("data",),
       param_spec={"grad_scale": 1.0, "valid_thresh": 0.0,
                   "normalization": "null"})
def _make_loss(attrs, data):
    """Custom-loss head: forward identity, backward grad_scale."""
    return _MakeLoss.apply(data, attrs)
