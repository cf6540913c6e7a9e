"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Replaces ``mxnet_tpu/ops/pallas/flash_attention.py``'s ``_fa_forward``
(the Pallas kernels ``_fa_kernel_res`` and ``_fa_kernel_stream``); the
kernel is ``csrc/flash_attention_fwd.cu``, whose header says what bounds
it and what its design does about that.

:func:`flash_attention` takes q (B, H, Tq, D) and k/v (B, Hkv, Tk, D) with
Hkv dividing H. For CPU tensors it runs :func:`flash_attention_plain`; for
CUDA tensors it launches the kernel and counts the launch in
``flash_attention.launches``, or raises — it never falls back. Unlike the
reference there is no shape contract beyond the kernel's own limits
(ragged lengths are masked in the kernel) and no minimum-length gate.
"""
from __future__ import annotations

import ctypes

import torch

from ..attention import grouped_logits

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "flash_attention_fwd"
_fn = None


def _check(q, k, v, causal):
    """Shape/type checks shared by both paths."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants 4-D q/k/v (B, H, T, D)")
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("k/v shape %s/%s does not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    hkv, tk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError("q heads %d not divisible by kv heads %d"
                         % (h, hkv))
    if causal and tq > tk:
        # the first tq - tk query rows would see no key at all
        raise ValueError("causal attention needs tq <= tk (got %d > %d)"
                         % (tq, tk))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")


def _check_kernel(q, k, v):
    """What the CUDA kernel takes, beyond :func:`_check`."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("flash kernel takes float32 or bfloat16, not %s"
                        % q.dtype)
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError("flash kernel head_dim must be one of %s, not %d"
                         % (HEAD_DIMS, q.shape[-1]))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError("flash kernel needs unit stride on the head "
                             "dim of %s" % name)
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("flash kernel grid: B*H must be <= 65535")


def flash_attention_plain(q, k, v, causal=False, scale=None,
                          return_lse=False):
    """Plain PyTorch version of the reference's Pallas forward: q/k/v
    widened to f32, f32 logits, softmax and PV product (the
    ``_grouped_attention`` math without its cast of the probabilities to
    v's type), the output cast back to the input type. With
    ``return_lse`` also returns the per-row logsumexp (B, H, Tq) in f32."""
    b, h, tq, d = q.shape
    logits = grouped_logits(q, k, k.shape[1], causal, scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", probs, v.float())
    out = out.reshape(b, h, tq, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b, h, tq)
    return out


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load(_NAME).mxtt_flash_attention_fwd
        i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 9
                       + [ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, causal, scale, return_lse):
    _check_kernel(q, k, v)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 _DTYPE_CODE[q.dtype], b, h, hkv, tq, tk, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError("flash_attention_fwd launch failed: cudaError %d"
                           % err)
    # one thread launches (the engine worker on the serving path)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, causal=False, scale=None, return_lse=False):
    """Attention over q (B, H, Tq, D) against k/v (B, Hkv, Tk, D).

    Query head i reads kv head i // (H / Hkv). ``causal`` aligns the last
    query with the last key (offset tk - tq). ``scale`` defaults to
    D**-0.5. Returns O like q, and with ``return_lse`` the per-row
    logsumexp (B, H, Tq) in f32 (the reference's ``with_lse`` output,
    there laid out (B*Hkv, G, 1, Tq)). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check(q, k, v, causal)
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: no path for device %s" % q.device)
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention: empty input %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))
    return _launch(q, k, v, causal, scale, return_lse)


flash_attention.launches = 0
