"""Fused optimizer updates: the CUDA kernels' wrappers and their plain
versions.

Replaces ``mxnet_tpu/ops/pallas/fused_update.py``'s ``sgd_mom_update`` and
``adam_update``; the kernels are ``csrc/fused_update.cu``, whose header says
what bounds them and what their design does about that.

Both update the weight and the state(s) **in place** (the counterpart of
the Pallas kernels' ``input_output_aliases``) and return them. f32 math
whatever the buffer type (float32 or bfloat16; all buffers of one call
share it). For CPU tensors the plain version runs; for CUDA tensors the
kernel launches and counts the launch in ``<wrapper>.launches``, or the
call raises — it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "fused_update"


def _prep(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_mom_update_plain(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * (clip(rescale * g) + wd * w); w += mom."""
    g = _prep(grad, rescale_grad, clip_gradient)
    w = weight.float()
    m = mom.float() * momentum - lr * (g + wd * w)
    new_w = w + m
    mom.copy_(m)
    weight.copy_(new_w)
    return weight, mom


def adam_update_plain(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0):
    """g = clip(rescale * g) + wd * w; mean/var moving averages of g and
    g * g; w -= lr * mean / (sqrt(var) + eps). No bias correction: the
    optimizer folds it into ``lr``."""
    w = weight.float()
    g = _prep(grad, rescale_grad, clip_gradient) + wd * w
    m = beta1 * mean.float() + (1 - beta1) * g
    v = beta2 * var.float() + (1 - beta2) * g * g
    new_w = w - lr * m / (torch.sqrt(v) + epsilon)
    mean.copy_(m)
    var.copy_(v)
    weight.copy_(new_w)
    return weight, mean, var


def _check(name, tensors):
    w = tensors[0]
    for t in tensors[1:]:
        if t.shape != w.shape or t.dtype != w.dtype or t.device != w.device:
            raise ValueError(
                "%s: every buffer must match the weight's shape, type and "
                "device (weight %s %s %s, got %s %s %s)"
                % (name, tuple(w.shape), w.dtype, w.device, tuple(t.shape),
                   t.dtype, t.device))


def _check_kernel(name, tensors):
    """What the CUDA kernel takes, beyond :func:`_check`."""
    if tensors[0].dtype not in _DTYPE_CODE:
        raise TypeError("%s kernel takes float32 or bfloat16, not %s"
                        % (name, tensors[0].dtype))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s kernel needs contiguous buffers" % name)


def _kernel(name, n_buffers, n_scalars):
    from . import _build

    ptr = ctypes.c_void_p
    return _build.kernel(_NAME, "mxtt_" + name,
                         [ptr] * n_buffers + [ctypes.c_int64, ctypes.c_int]
                         + [ctypes.c_float] * n_scalars + [ptr])


def _dispatch(wrapper, plain, tensors, scalars):
    """Plain version for CPU tensors; the kernel for CUDA tensors, counted
    in ``wrapper.launches``."""
    name = wrapper.__name__
    _check(name, tensors)
    w = tensors[0]
    if w.device.type == "cpu":
        return plain(*tensors, *scalars)
    if w.device.type != "cuda":
        raise ValueError("%s: no path for device %s" % (name, w.device))
    _check_kernel(name, tensors)
    if w.numel() == 0:
        return tuple(t for i, t in enumerate(tensors) if i != 1)
    fn = _kernel(name, len(tensors), len(scalars))
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), w.numel(),
                 _DTYPE_CODE[w.dtype], *(float(s) for s in scalars), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))
    wrapper.launches += 1
    return tuple(t for i, t in enumerate(tensors) if i != 1)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """In-place momentum SGD on (weight, mom); returns them. Scalars after
    ``mom`` are the kernel's arguments, in the reference's order."""
    clip = -1.0 if clip_gradient is None else clip_gradient
    return _dispatch(sgd_mom_update, sgd_mom_update_plain,
                     (weight, grad, mom),
                     (lr, momentum, wd, rescale_grad, clip))


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In-place Adam on (weight, mean, var); returns them. ``lr`` carries
    the bias correction, as the reference optimizer passes it."""
    clip = -1.0 if clip_gradient is None else clip_gradient
    return _dispatch(adam_update, adam_update_plain,
                     (weight, grad, mean, var),
                     (lr, beta1, beta2, epsilon, wd, rescale_grad, clip))


sgd_mom_update.launches = 0
adam_update.launches = 0
