"""Contrib operators: the quantization part.

Counterpart of the quantization section of ``mxnet_tpu/ops/contrib.py``
(reference src/operator/contrib/quantize.cc): the symmetric per-tensor /
per-channel math shared by the ``quantize`` / ``dequantize`` ops and the
weight quantization pass (``mxnet_tpu_torch.quant``), and the two ops.
int8 is ``torch.int8``, fp8-e4m3 ``torch.float8_e4m3fn``; rounding is half
to even (``torch.round``, as ``jnp.round``). The fp8 path does not clip:
``|data / scale| <= 448`` by construction, and a cast of a value a rounding
step above 448 lands on 448 in both packages.

The other contrib ops (CTC loss, FFT, count_sketch, the SSD and RCNN ops)
are not ported.
"""
from __future__ import annotations

import torch

from .registry import defop

#: symmetric target formats -> the largest exactly representable magnitude
#: the scale maps absmax onto (int8: 127; fp8-e4m3: 448)
SYMMETRIC_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}


def _symmetric_dtype(out_type: str) -> torch.dtype:
    if out_type == "int8":
        return torch.int8
    if out_type == "fp8_e4m3":
        return torch.float8_e4m3fn
    raise ValueError("symmetric quantization supports int8/fp8_e4m3, got %r"
                     % (out_type,))


def true_divide(num, den):
    """``num / den`` as a division of two tensors, either of which may be
    given as a Python number. PyTorch divides a CUDA tensor by a Python
    number as a product with the number's reciprocal (one ulp off for
    about one value in twenty), and a Python number by any tensor as the
    tensor's reciprocal times the number, on every device; the reference
    divides. A number is made a tensor like the other operand first, so
    the card and the CPU both divide."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    elif not isinstance(den, torch.Tensor):
        den = torch.full_like(num, den)
    return num / den


def symmetric_scale(amax, qmax: float):
    """``max(amax, 1e-12) / qmax`` in f32, a true division on every device
    (:func:`true_divide`), equal to the reference's ``amax / qmax``."""
    return true_divide(torch.clamp(amax, min=1e-12).to(torch.float32), qmax)


def quantize_symmetric(data, out_type: str = "int8", axis=None):
    """``q = round(data / scale)`` with ``scale = absmax / qmax``.

    ``axis=None`` is per-tensor (one scale); an int or tuple names the
    channel axes kept distinct, the scale reducing over every other axis.
    Returns ``(q, scale)`` with ``scale`` f32 and keepdims-shaped, so
    ``q * scale`` broadcasts back."""
    qmax = SYMMETRIC_QMAX[out_type]
    dtype = _symmetric_dtype(out_type)
    if axis is None:
        amax = data.abs().amax().reshape((1,) * data.ndim)
    else:
        keep = {a % data.ndim for a in
                (axis if isinstance(axis, (tuple, list)) else (axis,))}
        reduce_axes = tuple(a for a in range(data.ndim) if a not in keep)
        amax = data.abs().amax(dim=reduce_axes, keepdim=True) \
            if reduce_axes else data.abs()
    scale = symmetric_scale(amax, qmax)
    q = data / scale
    if out_type == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale


def dequantize_symmetric(q, scale):
    """Inverse of :func:`quantize_symmetric` (f32 result)."""
    return q.to(torch.float32) * scale.to(torch.float32)


@defop("quantize", arg_names=("data", "min_range", "max_range"),
       param_spec={"out_type": "uint8", "axis": None}, num_outputs=3,
       no_grad_inputs=("min_range", "max_range"))
def _quantize(attrs, data, min_range, max_range):
    """Affine float -> uint8 from the calibration range; with ``out_type``
    int8 / fp8_e4m3, symmetric per-tensor or per-``axis`` (the ranges are
    then ignored, and the range outputs carry -/+ scale * qmax)."""
    out_type = attrs["out_type"]
    if out_type in SYMMETRIC_QMAX:
        q, scale = quantize_symmetric(data, out_type, attrs["axis"])
        qmax = SYMMETRIC_QMAX[out_type]
        return q, -scale * qmax, scale * qmax
    qmax = 255.0
    scale = true_divide(qmax, max_range - min_range)
    q = torch.clamp(torch.round((data - min_range) * scale), 0, qmax)
    return q.to(torch.uint8), min_range, max_range


@defop("dequantize", arg_names=("data", "min_range", "max_range"),
       param_spec={"out_type": "float32"},
       no_grad_inputs=("data", "min_range", "max_range"))
def _dequantize(attrs, data, min_range, max_range):
    """uint8 back to f32 through the range; int8 / fp8 symmetric, where
    ``max_range`` carries scale * qmax."""
    if data.dtype in (torch.int8, torch.float8_e4m3fn):
        qmax = SYMMETRIC_QMAX["int8" if data.dtype == torch.int8
                              else "fp8_e4m3"]
        return dequantize_symmetric(data, true_divide(max_range, qmax))
    scale = true_divide(max_range - min_range, 255.0)
    return data.to(torch.float32) * scale + min_range
