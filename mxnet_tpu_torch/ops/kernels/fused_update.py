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

Each has a second entry point, ``sgd_mom_update_lr`` / ``adam_update_lr``,
that takes lr and wd as two f32 device arrays and an index: the kernel
reads ``lr_arr[index]`` and ``wd_arr[index]`` when it starts. A training
step captured in a CUDA graph calls it, so a new lr (a schedule, a
multiplier, Adam's bias correction) needs no new capture: the reference
passes them to its jitted step as traced arrays. The results equal the
scalar entry points' bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ._launches import counted

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "fused_update"


def _prep(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Plain SGD, w - lr * (clip(rescale * g) + wd * w), as a new tensor.
    It has no kernel, as in the reference; ``lr`` and ``wd`` may be
    floats or 0-d tensors (the fused step's)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    return (weight - lr * (g + wd * weight)).to(weight.dtype)


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


def sgd_mom_update_lr_plain(weight, grad, mom, lr_arr, wd_arr, index,
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0):
    """:func:`sgd_mom_update_plain` with lr = lr_arr[index], wd =
    wd_arr[index] (f32 0-d tensors: the same f32 math as the scalars)."""
    return sgd_mom_update_plain(weight, grad, mom, lr_arr[index], momentum,
                                wd_arr[index], rescale_grad, clip_gradient)


def adam_update_lr_plain(weight, grad, mean, var, lr_arr, wd_arr, index,
                         beta1=0.9, beta2=0.999, epsilon=1e-8,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """:func:`adam_update_plain` with lr = lr_arr[index], wd =
    wd_arr[index]."""
    return adam_update_plain(weight, grad, mean, var, lr_arr[index], beta1,
                             beta2, epsilon, wd_arr[index], rescale_grad,
                             clip_gradient)


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


def _check_lr(name, w, lr_arr, wd_arr, index):
    """The device-lr entry points' arrays: f32, 1-D, contiguous, on the
    weight's device, ``index`` inside them."""
    for what, a in (("lr_arr", lr_arr), ("wd_arr", wd_arr)):
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32 \
                or a.dim() != 1 or a.device != w.device \
                or not a.is_contiguous():
            raise ValueError("%s: %s must be a contiguous 1-D float32 tensor "
                             "on %s" % (name, what, w.device))
        if not 0 <= index < a.numel():
            raise IndexError("%s: index %d outside %s of %d"
                             % (name, index, what, a.numel()))


def _kernel(name, n_buffers, n_scalars, device_lr=False):
    from . import _build

    ptr = ctypes.c_void_p
    lr = [ptr, ptr, ctypes.c_int64] if device_lr else []
    return _build.kernel(_NAME, "mxtt_" + name,
                         [ptr] * n_buffers + [ctypes.c_int64, ctypes.c_int]
                         + lr + [ctypes.c_float] * n_scalars + [ptr])


def _dispatch(wrapper, plain, tensors, scalars, lr=None):
    """Plain version for CPU tensors; the kernel for CUDA tensors, counted
    in ``wrapper.launches``. ``lr`` (lr_arr, wd_arr, index) is the
    device-lr entry point's, passed before the scalars."""
    name = wrapper.__name__
    _check(name, tensors)
    w = tensors[0]
    if lr is not None:
        _check_lr(name, w, *lr)
    if w.device.type == "cpu":
        return plain(*tensors, *(lr or ()), *scalars)
    if w.device.type != "cuda":
        raise ValueError("%s: no path for device %s" % (name, w.device))
    _check_kernel(name, tensors)
    if w.numel() == 0:
        return tuple(t for i, t in enumerate(tensors) if i != 1)
    fn = _kernel(name, len(tensors), len(scalars), lr is not None)
    lr_args = () if lr is None else (lr[0].data_ptr(), lr[1].data_ptr(),
                                     int(lr[2]))
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), w.numel(),
                 _DTYPE_CODE[w.dtype], *lr_args,
                 *(float(s) for s in scalars), stream)
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


def sgd_mom_update_lr(weight, grad, mom, lr_arr, wd_arr, index,
                      momentum=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """:func:`sgd_mom_update` with lr = ``lr_arr[index]`` and wd =
    ``wd_arr[index]`` read on the device (f32 1-D arrays on the weight's
    device)."""
    clip = -1.0 if clip_gradient is None else clip_gradient
    return _dispatch(sgd_mom_update_lr, sgd_mom_update_lr_plain,
                     (weight, grad, mom), (momentum, rescale_grad, clip),
                     lr=(lr_arr, wd_arr, index))


def adam_update_lr(weight, grad, mean, var, lr_arr, wd_arr, index,
                   beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """:func:`adam_update` with lr = ``lr_arr[index]`` (the bias
    correction folded in) and wd = ``wd_arr[index]`` read on the
    device."""
    clip = -1.0 if clip_gradient is None else clip_gradient
    return _dispatch(adam_update_lr, adam_update_lr_plain,
                     (weight, grad, mean, var),
                     (beta1, beta2, epsilon, rescale_grad, clip),
                     lr=(lr_arr, wd_arr, index))


for _wrapper in (sgd_mom_update, adam_update, sgd_mom_update_lr,
                 adam_update_lr):
    counted(_wrapper)
