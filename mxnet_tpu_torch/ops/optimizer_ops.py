"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
src/operator/tensor/optimizer_op.cc): ``sgd_update`` in plain PyTorch
(the reference has no kernel for it), and ``sgd_mom_update`` /
``adam_update``, which run the fused kernels of
``ops/kernels/fused_update.py`` and update the weight and the state(s)
**in place**, returning those same tensors — where the reference returns
new arrays and rebinds its handles.
"""
from __future__ import annotations

from .kernels import fused_update as _fu
from .registry import defop

_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


@defop("sgd_update", arg_names=("weight", "grad"), param_spec=dict(_COMMON))
def _sgd_update(attrs, weight, grad):
    """weight - lr * (clip(rescale * grad) + wd * weight), a new tensor."""
    g = _fu._prep(grad, attrs["rescale_grad"], attrs["clip_gradient"])
    return (weight - attrs["lr"] * (g + attrs["wd"] * weight)).to(
        weight.dtype)


@defop("sgd_mom_update", arg_names=("weight", "grad", "mom"),
       param_spec=dict(_COMMON, momentum=0.0), num_outputs=2)
def _sgd_mom_update(attrs, weight, grad, mom):
    """mom = momentum * mom - lr * g; weight += mom, in place. Returns
    (weight, mom)."""
    return _fu.sgd_mom_update(weight, grad, mom, attrs["lr"],
                              attrs["momentum"], attrs["wd"],
                              attrs["rescale_grad"], attrs["clip_gradient"])


@defop("adam_update", arg_names=("weight", "grad", "mean", "var"),
       param_spec=dict(_COMMON, beta1=0.9, beta2=0.999, epsilon=1e-8),
       num_outputs=3)
def _adam_update(attrs, weight, grad, mean, var):
    """Adam step in place; returns (weight, mean, var). Bias correction is
    folded into lr by the optimizer, as in the reference."""
    return _fu.adam_update(weight, grad, mean, var, attrs["lr"],
                           attrs["beta1"], attrs["beta2"], attrs["epsilon"],
                           attrs["wd"], attrs["rescale_grad"],
                           attrs["clip_gradient"])
