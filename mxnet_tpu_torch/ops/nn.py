"""Neural-network layer operators.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` the ported paths use
(reference src/operator/*): ``FullyConnected``, ``Activation``, the softmax
family, and the loss heads ``SoftmaxOutput`` and ``MakeLoss``. The loss
heads keep the reference's backward semantics, which ignore the incoming
head gradient; each is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import alias, defop


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
