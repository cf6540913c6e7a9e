"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
src/operator/tensor/optimizer_op.cc): ``sgd_update`` in plain PyTorch
(the reference has no kernel for it), ``sgd_mom_update`` /
``adam_update``, which run the fused kernels of
``ops/kernels/fused_update.py``, and ``rmsprop_update`` /
``rmspropalex_update`` in plain PyTorch, as the JAX package computes them
in ``jnp`` (no Pallas kernel). All but ``sgd_update`` update the weight
and the state(s) **in place**, returning those same tensors — where the
reference returns new arrays and rebinds its handles. :func:`rmsprop` and
:func:`rmspropalex` are the two RMSProp ops' math on tensors, which
``RMSProp.pure_rule`` calls with lr and wd as 0-d tensors.
"""
from __future__ import annotations

import torch

from .kernels import fused_update as _fu
from .registry import defop

_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


@defop("sgd_update", arg_names=("weight", "grad"), param_spec=dict(_COMMON))
def _sgd_update(attrs, weight, grad):
    """weight - lr * (clip(rescale * grad) + wd * weight), a new tensor."""
    return _fu.sgd_update(weight, grad, attrs["lr"], attrs["wd"],
                          attrs["rescale_grad"], attrs["clip_gradient"])


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


def _prep_grad(grad, weight, rescale, clip, wd):
    g = grad * rescale
    if clip is not None and clip > 0:
        g = g.clamp(-clip, clip)
    return g + wd * weight


def _clip_weights(w, cw):
    return w.clamp(-cw, cw) if cw is not None and cw > 0 else w


def rmsprop(weight, grad, n, lr, wd, rescale, clip, gamma1, epsilon,
            clip_weights):
    """RMSProp (Tieleman & Hinton) in place: n = (1 - gamma1) g^2 +
    gamma1 n; w -= lr g / sqrt(n + epsilon), clamped to +-clip_weights
    when it is > 0."""
    g = _prep_grad(grad, weight, rescale, clip, wd)
    n.copy_((1 - gamma1) * torch.square(g) + gamma1 * n)
    weight.copy_(_clip_weights(weight - lr * g / torch.sqrt(n + epsilon),
                               clip_weights))
    return weight, n


def rmspropalex(weight, grad, n, g_state, delta, lr, wd, rescale, clip,
                gamma1, gamma2, epsilon, clip_weights):
    """RMSProp, Graves 2013 (centered) in place: n and g the moving
    averages of g^2 and g, delta = gamma2 delta - lr g / sqrt(n - g^2 +
    epsilon), w += delta, clamped as :func:`rmsprop`."""
    g = _prep_grad(grad, weight, rescale, clip, wd)
    n.copy_((1 - gamma1) * torch.square(g) + gamma1 * n)
    g_state.copy_((1 - gamma1) * g + gamma1 * g_state)
    delta.copy_(gamma2 * delta - lr * g / torch.sqrt(
        n - torch.square(g_state) + epsilon))
    weight.copy_(_clip_weights(weight + delta, clip_weights))
    return weight, n, g_state, delta


@defop("rmsprop_update", arg_names=("weight", "grad", "n"),
       param_spec=dict(_COMMON, gamma1=0.95, epsilon=1e-8,
                       clip_weights=-1.0), num_outputs=2)
def _rmsprop_update(attrs, weight, grad, n):
    """RMSProp step in place; returns (weight, n)."""
    return rmsprop(weight, grad, n, attrs["lr"], attrs["wd"],
                   attrs["rescale_grad"], attrs["clip_gradient"],
                   attrs["gamma1"], attrs["epsilon"], attrs["clip_weights"])


@defop("rmspropalex_update", arg_names=("weight", "grad", "n", "g", "delta"),
       param_spec=dict(_COMMON, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                       clip_weights=-1.0), num_outputs=4)
def _rmspropalex_update(attrs, weight, grad, n, g, delta):
    """Centered RMSProp step in place; returns (weight, n, g, delta)."""
    return rmspropalex(weight, grad, n, g, delta, attrs["lr"], attrs["wd"],
                       attrs["rescale_grad"], attrs["clip_gradient"],
                       attrs["gamma1"], attrs["gamma2"], attrs["epsilon"],
                       attrs["clip_weights"])
