"""Neural-network layer operators.

Counterpart of ``mxnet_tpu/ops/nn.py`` (reference src/operator/*):
``FullyConnected`` (and ``QuantizedFullyConnected`` over
``matrix.quantized_matmul``), ``Convolution`` and ``Deconvolution``,
``Pooling``, ``UpSampling``, ``BatchNorm``, ``InstanceNorm``,
``L2Normalization``, ``LRN``, ``Activation``, ``LeakyReLU``, ``Dropout``,
the softmax family, ``GridGenerator`` / ``BilinearSampler`` /
``SpatialTransformer``, ``ROIPooling``, ``Crop``,
``IdentityAttachKLSparseReg``, and the loss heads ``SoftmaxOutput``,
``MakeLoss``, ``SVMOutput`` and the three regression outputs. The loss
heads keep the reference's backward semantics, which ignore the incoming
head gradient; each is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``).
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
from .matrix import quantized_matmul
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


@defop("QuantizedFullyConnected",
       arg_names=lambda attrs: (("data", "weight", "scale")
                                if attrs.get("no_bias")
                                else ("data", "weight", "scale", "bias")),
       param_spec={"num_hidden": 0, "no_bias": False, "flatten": True,
                   "act_dtype": "int8"},
       no_grad_inputs=("weight", "scale"))
def _quantized_fully_connected(attrs, data, weight, scale, bias=None):
    """FullyConnected over a per-channel quantized int8 / fp8 weight
    (weight (O, I), scale (O,): the output of ``mxnet_tpu_torch.quant``),
    its product ``matrix.quantized_matmul`` with ``act_dtype``'s
    strategy (int8 | bf16 | float32)."""
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = quantized_matmul(x, weight, scale, attrs["act_dtype"])
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


def takes_wgrad(attrs):
    """Whether a Convolution of ``attrs`` takes its weight gradient from
    the ``conv_wgrad`` kernel: a 3x3 window, dilation 1, one group, one
    stride and one pad on both axes."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    if kernel != (3, 3):
        return False
    stride = _ntuple(attrs["stride"], 2)
    pad = _ntuple(attrs["pad"], 2) if attrs["pad"] else (0, 0)
    return (_ntuple(attrs["dilate"], 2) == (1, 1)
            and int(attrs["num_group"]) == 1
            and stride[0] == stride[1] and pad[0] == pad[1])


@defop("Convolution",
       arg_names=lambda attrs: (("data", "weight") if attrs.get("no_bias")
                                else ("data", "weight", "bias")),
       param_spec=_CONV_SPEC)
def _convolution(attrs, data, weight, bias=None):
    """N-d convolution, data NC+spatial, weight OI+spatial (reference
    convolution-inl.h:90-288). The windows of :func:`takes_wgrad` take
    their weight gradient from the ``conv_wgrad`` kernel; every other
    window stays on autograd, as the reference leaves it to XLA."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    n = len(kernel)
    if attrs["layout"] not in (None, "NCW", "NCHW", "NCDHW"):
        raise MXNetError("Convolution layout %r is not ported (NC+spatial "
                         "only)" % (attrs["layout"],))
    stride = _ntuple(attrs["stride"], n)
    dilate = _ntuple(attrs["dilate"], n)
    pad = _ntuple(attrs["pad"], n) if attrs["pad"] else (0,) * n
    groups = int(attrs["num_group"])
    if takes_wgrad(attrs):
        out = _Conv2dWgrad.apply(data, weight, stride[0], pad[0])
    else:
        out = _CONV[n](data, weight, stride=stride, padding=pad,
                       dilation=dilate, groups=groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


alias("Convolution", "Convolution_v1")


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _transposed_conv(data, weight, out_sp, stride, pad, dilate, groups):
    """The gradient of a convolution (``weight`` OI+spatial: O = data's
    channels) with respect to its input of spatial size ``out_sp``, at the
    cotangent ``data``: the reference's deconvolution. Where the
    convolution of ``out_sp`` has more windows than ``data`` has positions
    (an ``adj`` at or past the stride, or an odd ``target_shape``
    difference), ``data`` is padded with trailing zeros, as the reference
    pads it; the remainder below one stride is the transposed
    convolution's ``output_padding``."""
    n = len(out_sp)
    dk = [dilate[i] * (weight.shape[2 + i] - 1) + 1 for i in range(n)]
    o_conv = [(out_sp[i] + 2 * pad[i] - dk[i]) // stride[i] + 1
              for i in range(n)]
    extra = [o_conv[i] - data.shape[2 + i] for i in range(n)]
    if any(e > 0 for e in extra):
        data = F.pad(data, [p for e in reversed(extra)
                            for p in (0, max(0, e))])
    out_pad = tuple(out_sp[i] - ((o_conv[i] - 1) * stride[i] - 2 * pad[i]
                                 + dk[i]) for i in range(n))
    return _CONV_T[n](data, weight, stride=stride, padding=pad,
                      output_padding=out_pad, groups=groups,
                      dilation=dilate)


@defop("Deconvolution",
       arg_names=lambda attrs: (("data", "weight")
                                if attrs.get("no_bias", True)
                                else ("data", "weight", "bias")),
       param_spec=dict(_CONV_SPEC, no_bias=True, adj=(), target_shape=()))
def _deconvolution(attrs, data, weight, bias=None):
    """Transposed convolution, weight (C_in, num_filter / num_group) +
    kernel (reference deconvolution-inl.h): out = (in - 1) * stride -
    2 * pad + dilated kernel + adj. ``no_bias`` defaults to True, unlike
    Convolution. ``target_shape`` overrides ``pad`` and ``adj``: pad =
    ceil((full - target) / 2), the rest lands in the trailing positions."""
    kernel = tuple(int(k) for k in attrs["kernel"])
    n = len(kernel)
    stride = _ntuple(attrs["stride"], n)
    pad = _ntuple(attrs["pad"], n) if attrs["pad"] else (0,) * n
    adj = _ntuple(attrs["adj"], n) if attrs["adj"] else (0,) * n
    dilate = _ntuple(attrs["dilate"], n)
    dk = tuple(dilate[i] * (kernel[i] - 1) + 1 for i in range(n))
    full = tuple((data.shape[2 + i] - 1) * stride[i] + dk[i]
                 for i in range(n))
    if attrs["target_shape"]:
        out_sp = tuple(int(t) for t in attrs["target_shape"])
        diff = tuple(f - t for f, t in zip(full, out_sp))
        if any(d < 0 for d in diff):
            raise ValueError("Deconvolution target_shape %s exceeds the "
                             "largest reachable output %s for input %s"
                             % (out_sp, full, tuple(data.shape[2:])))
        pad = tuple((d + 1) // 2 for d in diff)
    else:
        out_sp = tuple(full[i] - 2 * pad[i] + adj[i] for i in range(n))
    out = _transposed_conv(data, weight, out_sp, stride, pad, dilate,
                           int(attrs["num_group"]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


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


@defop("InstanceNorm", arg_names=("data", "gamma", "beta"),
       param_spec={"eps": 1e-3})
def _instance_norm(attrs, data, gamma, beta):
    """Normalize each instance's channel over its spatial axes (biased
    variance), then scale and shift per channel (reference
    instance_norm-inl.h)."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    centered = data - mean
    var = (centered * centered).mean(dim=red, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return centered * torch.rsqrt(var + attrs["eps"]) * \
        gamma.reshape(bshape) + beta.reshape(bshape)


@defop("L2Normalization", arg_names=("data",),
       param_spec={"eps": 1e-10, "mode": "instance"})
def _l2_normalization(attrs, data):
    """``x / sqrt(sum(x^2) + eps)`` over each instance (``instance``), the
    channel axis (``channel``) or the spatial axes (``spatial``)
    (reference l2_normalization-inl.h)."""
    mode = attrs["mode"]
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    norm = torch.sqrt((data * data).sum(dim=red, keepdim=True)
                      + attrs["eps"])
    return data / norm


@defop("LRN", arg_names=("data",),
       param_spec={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0, "nsize": 5})
def _lrn(attrs, data):
    """Cross-channel local response normalization (reference lrn-inl.h):
    ``x * (knorm + alpha / nsize * S) ^ -beta``, S the sum of squares
    over the ``nsize`` channels around each, built as the reference
    builds it: ``nsize`` shifted slices of the zero-padded square, added
    in order."""
    nsize = int(attrs["nsize"])
    half = nsize // 2
    sq = data * data
    flat = [0, 0] * (data.dim() - 2) + [half, half]
    sqp = F.pad(sq, flat)
    c = data.shape[1]
    acc = sqp[:, 0:c]
    for i in range(1, nsize):
        acc = acc + sqp[:, i:i + c]
    return data * torch.pow(attrs["knorm"] + attrs["alpha"] / nsize * acc,
                            -attrs["beta"])


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


@defop("LeakyReLU",
       arg_names=lambda attrs: (("data", "gamma")
                                if attrs.get("act_type") == "prelu"
                                else ("data",)),
       param_spec={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                   "upper_bound": 0.334})
def _leaky_relu(attrs, data, gamma=None):
    """leaky (``slope * x`` below 0), elu (``slope * expm1(x)``), prelu (a
    learned slope per channel, ``gamma``) and rrelu at its mean slope
    (``(lower_bound + upper_bound) / 2``, training included, as the JAX
    package) (reference leaky_relu-inl.h)."""
    act = attrs["act_type"]
    if act == "leaky":
        neg = attrs["slope"] * data
    elif act == "elu":
        neg = attrs["slope"] * torch.expm1(data)
    elif act == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if data.dim() > 1 else gamma
        neg = g * data
    elif act == "rrelu":
        neg = (attrs["lower_bound"] + attrs["upper_bound"]) / 2.0 * data
    else:
        raise MXNetError("unknown act_type %r" % act)
    return torch.where(data > 0, data, neg)


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


@defop("SoftmaxActivation", arg_names=("data",),
       param_spec={"mode": "instance"})
def _softmax_activation(attrs, data):
    """Softmax over each instance's features (``instance``) or over the
    channel axis at each position (``channel``) (reference
    softmax_activation-inl.h)."""
    if attrs["mode"] == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


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


class _RegressionOutput(torch.autograd.Function):
    """``link(data)`` forward; backward ``grad(out, label) * grad_scale /
    (outputs per sample)``, the label reshaped to the output's shape,
    whatever the head gradient (regression_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, link, grad, scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.scale = grad, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out  # the head gradient is ignored, as in the reference
        out, lab = ctx.saved_tensors
        num_out = int(np.prod(out.shape[1:])) if out.dim() > 1 else 1
        grad = ctx.grad(out, lab.reshape(out.shape)) * (ctx.scale / num_out)
        return grad.to(out.dtype), None, None, None, None


def _regression_output(name, link, grad):
    @defop(name, arg_names=("data", "label"), param_spec={"grad_scale": 1.0},
           no_grad_inputs=("label",))
    def impl(attrs, data, label):
        return _RegressionOutput.apply(data, label, link, grad,
                                       float(attrs["grad_scale"]))


_regression_output("LinearRegressionOutput", lambda d: d.clone(),
                   lambda o, lab: o - lab)
_regression_output("MAERegressionOutput", lambda d: d.clone(),
                   lambda o, lab: torch.sign(o - lab))
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda o, lab: o - lab)


class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the hinge loss's push on each score that
    comes within ``margin`` of the label's, L2 (squared hinge) or L1
    (``use_linear``), whatever the head gradient (svm_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        ctx.save_for_backward(data, label)
        ctx.attrs = attrs
        return data.clone()

    @staticmethod
    def backward(ctx, grad_out):
        del grad_out  # the head gradient is ignored, as in the reference
        d, lab = ctx.saved_tensors
        attrs = ctx.attrs
        margin, reg = attrs["margin"], attrs["regularization_coefficient"]
        oh = _one_hot_like(lab, d.shape[1], d.dtype)
        score_y = (d * oh).sum(dim=1, keepdim=True)
        dist = margin - (score_y - d)
        if attrs["use_linear"]:
            viol = (dist > 0).to(d.dtype) * (1 - oh)
            grad = reg * (viol - oh * viol.sum(dim=1, keepdim=True))
        else:
            viol = dist.clamp(min=0) * (1 - oh)
            grad = 2 * reg * (viol - oh * viol.sum(dim=1, keepdim=True))
        return grad, None, None


@defop("SVMOutput", arg_names=("data", "label"),
       param_spec={"margin": 1.0, "regularization_coefficient": 1.0,
                   "use_linear": False},
       no_grad_inputs=("label",))
def _svm_output(attrs, data, label):
    """Hinge-loss output head: forward identity."""
    return _SVMOutput.apply(data, label, attrs)


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparseness penalty's
    gradient from this batch's mean activation rho (not the moving
    average): ``penalty * (-t / rho + (1 - t) / (1 - rho))``."""

    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(data.mean(dim=0))
        ctx.target, ctx.penalty = target, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        t = ctx.target
        reg = ctx.penalty * (-t / rho.clamp(min=1e-8)
                             + (1 - t) / (1 - rho).clamp(min=1e-8))
        return g + reg.unsqueeze(0), None, None


@defop("IdentityAttachKLSparseReg", arg_names=("data",),
       aux_names=("moving_avg",),
       param_spec={"sparseness_target": 0.1, "penalty": 0.001,
                   "momentum": 0.9},
       simple=False)
def _identity_kl_sparse(attrs, inputs, aux, ctx):
    """Identity with a KL sparseness regularizer on its backward
    (reference identity_attach_KL_sparse_reg-inl.h); ``moving_avg``
    follows the batch mean only in training."""
    (data,) = inputs
    (moving,) = aux
    m = attrs["momentum"]
    if ctx.is_train:
        moving = moving * m + data.detach().mean(dim=0) * (1 - m)
    out = _KLSparseReg.apply(data, float(attrs["sparseness_target"]),
                             float(attrs["penalty"]))
    return (out,), (moving,)


@defop("UpSampling", arg_names=(), variadic=True,
       param_spec={"scale": 1, "num_filter": 0, "sample_type": "nearest",
                   "multi_input_mode": "concat", "num_args": 1,
                   "workspace": 512})
def _upsampling(attrs, *inputs):
    """Nearest: each input's pixels repeated ``scale`` times on both
    spatial axes, several inputs concatenated on the channels (or summed,
    ``multi_input_mode="sum"``). Bilinear: inputs (data, weight), a
    transposed convolution of stride ``scale`` with one group a channel,
    the weight (C, 1, k, k), padded by the reference's formula
    ceil((k - scale) / 2) (reference upsampling-inl.h)."""
    scale = int(attrs["scale"])
    if attrs["sample_type"] == "nearest":
        outs = [x.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3) for x in inputs]
        if len(outs) == 1:
            return outs[0]
        if attrs["multi_input_mode"] == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    data, weight = inputs
    kernel = weight.shape[-1]
    pad = (kernel - scale + 1) // 2
    out_sp = tuple(sz * scale for sz in data.shape[2:])
    return _transposed_conv(data, weight, out_sp, (scale, scale),
                            (pad, pad), (1, 1), data.shape[1])


def _affine_grid(theta, h, w):
    """(n, 2, h, w) source points of an affine map ``theta`` (n, 6) over
    the target's [-1, 1] x [-1, 1] grid, x first."""
    n = theta.shape[0]
    ys = torch.linspace(-1, 1, h, dtype=theta.dtype, device=theta.device)
    xs = torch.linspace(-1, 1, w, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])
    return torch.matmul(theta.reshape(n, 2, 3), grid).reshape(n, 2, h, w)


@defop("GridGenerator", arg_names=("data",),
       param_spec={"transform_type": "affine", "target_shape": (0, 0)})
def _grid_generator(attrs, data):
    """A sampling grid for ``BilinearSampler`` (reference
    grid_generator-inl.h): ``affine`` maps the target grid by data (n, 6);
    ``warp`` adds the flow data (n, 2, h, w) to the pixel grid and
    normalizes to [-1, 1]."""
    if attrs["transform_type"] == "affine":
        h, w = (int(t) for t in attrs["target_shape"])
        return _affine_grid(data, h, w)
    _, _, h, w = data.shape
    ys = torch.arange(h, dtype=data.dtype, device=data.device)
    xs = torch.arange(w, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x = (data[:, 0] + gx) * (2.0 / max(w - 1, 1)) - 1
    y = (data[:, 1] + gy) * (2.0 / max(h - 1, 1)) - 1
    return torch.stack([x, y], dim=1)


def _bilinear_sample(data, grid):
    """Sample data (n, c, h, w) at the grid (n, 2, oh, ow) of [-1, 1]
    points, x first, mapped to pixels by ``(g + 1) (size - 1) / 2``: the
    four corners' gather, each corner outside the image (by its unclipped
    index) contributing 0. Not ``F.grid_sample``, whose gradient with
    respect to the grid differs at integer points."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    flat = data.reshape(n, c, h * w)

    def gather(yi, xi):
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        idx = idx.reshape(n, 1, -1).expand(n, c, idx[0].numel())
        out = torch.gather(flat, 2, idx).reshape((n, c) + gx.shape[1:])
        inb = ((yi >= 0) & (yi <= h - 1) & (xi >= 0)
               & (xi <= w - 1)).to(data.dtype)
        return out * inb.unsqueeze(1)

    return (gather(y0, x0) * ((1 - wy) * (1 - wx)).unsqueeze(1)
            + gather(y0, x0 + 1) * ((1 - wy) * wx).unsqueeze(1)
            + gather(y0 + 1, x0) * (wy * (1 - wx)).unsqueeze(1)
            + gather(y0 + 1, x0 + 1) * (wy * wx).unsqueeze(1))


@defop("BilinearSampler", arg_names=("data", "grid"), param_spec={})
def _bilinear_sampler(attrs, data, grid):
    """Bilinear sampling of data at the grid (reference
    bilinear_sampler-inl.h)."""
    return _bilinear_sample(data, grid)


@defop("SpatialTransformer", arg_names=("data", "loc"),
       param_spec={"target_shape": (0, 0), "transform_type": "affine",
                   "sampler_type": "bilinear", "cudnn_off": False})
def _spatial_transformer(attrs, data, loc):
    """The affine ``GridGenerator`` of ``loc`` then ``BilinearSampler``
    (reference spatial_transformer-inl.h)."""
    h, w = (int(t) for t in attrs["target_shape"])
    return _bilinear_sample(data, _affine_grid(loc, h, w))


@defop("ROIPooling", arg_names=("data", "rois"),
       param_spec={"pooled_size": (0, 0), "spatial_scale": 1.0},
       no_grad_inputs=("rois",))
def _roi_pooling(attrs, data, rois):
    """Max pooling of each region (rois (R, 5): batch index, x1, y1, x2,
    y2) into ``pooled_size`` bins (reference roi_pooling-inl.h). Corners
    are ``round(coord * spatial_scale)``, half to even; bin i of a side
    spans [floor(i L / p), ceil((i + 1) L / p)), at least one pixel; a bin
    outside the image gives 0. One max over each bin's pixels, so its
    gradient is split evenly among tied maxima, as ``jnp.max``'s."""
    ph, pw = (int(p) for p in attrs["pooled_size"])
    scale = attrs["spatial_scale"]
    _, _, h, w = data.shape
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).long()
                      for i in (1, 2, 3, 4))
    rh = (y2 - y1 + 1).clamp(min=1)
    rw = (x2 - x1 + 1).clamp(min=1)

    def bins(start, length, pooled, size):
        """(R, pooled, size): whether each pixel lies in each bin."""
        i = torch.arange(pooled, device=data.device)
        lo = start[:, None] + torch.div(i * length[:, None], pooled,
                                        rounding_mode="floor")
        hi = start[:, None] - torch.div(-(i + 1) * length[:, None], pooled,
                                        rounding_mode="floor")
        hi = torch.maximum(hi, lo + 1)
        pix = torch.arange(size, device=data.device)
        return (pix >= lo[..., None]) & (pix < hi[..., None])

    mask = bins(y1, rh, ph, h)[:, :, None, :, None] & \
        bins(x1, rw, pw, w)[:, None, :, None, :]  # (R, ph, pw, h, w)
    img = data[b][:, :, None, None]  # (R, c, 1, 1, h, w)
    vals = torch.where(mask[:, None], img,
                       torch.tensor(float("-inf"), dtype=data.dtype,
                                    device=data.device))
    cells = vals.amax(dim=(-2, -1))
    return torch.where(torch.isfinite(cells), cells, torch.zeros_like(cells))


@defop("Crop",
       arg_names=lambda attrs: (("data", "crop_like")
                                if int(attrs.get("num_args", 1)) == 2
                                else ("data",)),
       param_spec={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                   "center_crop": False},
       no_grad_inputs=("crop_like",))
def _crop(attrs, data, crop_like=None):
    """The spatial window of ``h_w`` (or of ``crop_like``'s size) at
    ``offset`` or centred (reference crop-inl.h); a view."""
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = (int(v) for v in attrs["h_w"])
    if attrs["center_crop"]:
        oy, ox = (data.shape[2] - th) // 2, (data.shape[3] - tw) // 2
    else:
        oy, ox = (int(v) for v in attrs["offset"])
    return data[:, :, oy:oy + th, ox:ox + tw]
