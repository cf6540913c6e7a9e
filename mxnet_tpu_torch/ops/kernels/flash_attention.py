"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd function that joins them.

Replaces ``mxnet_tpu/ops/pallas/flash_attention.py``'s ``_fa_forward``
(the Pallas kernels ``_fa_kernel_res`` and ``_fa_kernel_stream``), now
``csrc/flash_attention_fwd.cu``, and its ``_fa_backward`` (the dQ and
dK/dV Pallas kernels), now ``csrc/flash_attention_bwd.cu`` (a dQ and a
dK/dV kernel per type); both are bf16 on ``wgmma`` fed by TMA and f32 on
register tiles fed by ``cp.async``. Each file's header says what bounds it
and what its design does about that. The reference's ``custom_vjp``
around the pair is :class:`FlashAttention`.

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
_FWD_ROWS = 128  # query rows of one forward block: grid y counts them
_BWD_ROWS = 64   # rows of the smallest backward block (f32): grid y
_BWD_NAME = "flash_attention_bwd"
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


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


def _check_kernel(q, k, v, backward=False):
    """What the CUDA kernels take, beyond :func:`_check`: the type, the
    head dim, a unit-stride head dim, and the grid: the forward's q-tiles
    of 128 rows, the backward's q- or k-tiles of 64 rows on grid y."""
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
    longest = max(q.shape[2], k.shape[2])
    if backward and -(-longest // _BWD_ROWS) > 65535:
        raise ValueError("flash backward grid: ceil(max(Tq, Tk) / %d) must "
                         "be <= 65535 (T %d)" % (_BWD_ROWS, longest))
    if not backward and -(-q.shape[2] // _FWD_ROWS) > 65535:
        raise ValueError("flash forward grid: ceil(Tq / %d) must be <= 65535"
                         " (Tq %d)" % (_FWD_ROWS, q.shape[2]))


def tensor_map_plan(t):
    """How the kernels read one of q/k/v/dO (B, heads, T, D) in place.

    Returns ``(strides, copy)``: ``strides`` = the byte strides of B, heads
    and T, as the C entries take them (the bf16 kernels' tensor maps run
    over (D, T, heads, B) with these strides; a singleton dim gets the
    stride it would have if the dims inside it were packed, since it is
    never stepped); ``copy`` = True when the kernels' 16-byte loads (TMA
    for bf16, ``cp.async`` for f32) cannot read ``t`` where it lies: the
    head dim is not unit-stride, or the base address or a stride is not a
    positive multiple of 16 bytes.
    """
    b, heads, seq, d = t.shape
    strides, packed = [], d * t.element_size()
    for size, stride in zip((seq, heads, b), t.stride()[2::-1]):
        strides.append(stride * t.element_size() if size > 1 else packed)
        packed = strides[-1] * size
    copy = t.stride(3) != 1 or t.data_ptr() % 16 != 0 \
        or any(s <= 0 or s % 16 for s in strides)
    return tuple(strides[::-1]), bool(copy)


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
    from . import _build

    return _build.kernel(_NAME, "mxtt_flash_attention_fwd",
                         [_PTR] * 5 + [_I32] * 7 + [_I64] * 9
                         + [ctypes.c_float, _I32, _PTR])


def _in_place(t):
    """``t`` and its byte strides (B, heads, T) as the kernel reads it:
    ``t`` itself where :func:`tensor_map_plan` allows, else a contiguous
    copy in fresh (aligned) memory; ``contiguous()`` would hand back a
    contiguous ``t`` whose base is off a 16-byte boundary."""
    strides, copy = tensor_map_plan(t)
    if copy:
        t = t.clone(memory_format=torch.contiguous_format)
        strides = tensor_map_plan(t)[0]
    return t, strides


def _launch(q, k, v, causal, scale, return_lse):
    (q, qs), (k, ks), (v, vs) = (_in_place(t) for t in (q, k, v))
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
                 _DTYPE_CODE[q.dtype], b, h, hkv, tq, tk, d, *qs, *ks, *vs,
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


# --- backward ----------------------------------------------------------------
def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """Plain PyTorch version of the reference's Pallas backward, all in f32:
    rebuild p = exp(scale * q.k - lse) from the forward's logsumexp,
    D = rowsum(dO * O), dV = p^T dO, dS = p * (dO v^T - D),
    dQ = scale * dS K, dK = scale * dS^T Q, with dK/dV summed over each
    GQA group. Returns (dq, dk, dv) of the input types."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / d ** 0.5
    logits = grouped_logits(q, k, hkv, causal, scale)     # (b, hkv, g, tq, tk)
    p = torch.exp(logits - lse.float().reshape(b, hkv, g, tq, 1))
    do5 = do.float().reshape(b, hkv, g, tq, d)
    dvec = (do5 * o.float().reshape(b, hkv, g, tq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgql,bkgqd->bkld", p, do5)
    dp = torch.einsum("bkgqd,bkld->bkgql", do5, v.float())
    ds = p * (dp - dvec)
    dq = torch.einsum("bkgql,bkld->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgql,bkgqd->bkld",
                      ds, q.float().reshape(b, hkv, g, tq, d)) * scale
    return (dq.reshape(b, h, tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_kernel():
    from . import _build

    return _build.kernel(_BWD_NAME, "mxtt_flash_attention_bwd",
                         [_I32] + [_PTR] * 9 + [_I32] * 7 + [_I64] * 12
                         + [ctypes.c_float, _I32, _PTR])


def _bwd_launch(which, name, q, k, v, do, strides, lse, dvec, dq, dk, dv,
                causal, scale):
    """Launch backward kernel ``which`` (0 dQ, 1 dK/dV) of the C entry on
    the operands and byte strides :func:`bwd_operands` gives."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
            _DTYPE_CODE[q.dtype], b, h, hkv, tq, tk, d, *strides,
            float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))


def flash_attention_bwd_dq(q, k, v, do, strides, lse, dvec, causal, scale):
    """Launch the dQ kernel on the inputs :func:`flash_attention_bwd`
    prepares (CUDA, :func:`bwd_operands` and their 12 byte strides,
    contiguous f32 lse and D = rowsum(dO * O)); returns dq and counts the
    launch in ``flash_attention_bwd_dq.launches``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch(0, "flash_attention_bwd dQ", q, k, v, do, strides, lse, dvec,
                dq, None, None, causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, strides, lse, dvec, causal, scale):
    """Launch the dK/dV kernel on the same inputs as
    :func:`flash_attention_bwd_dq`; returns (dk, dv) and counts the launch
    in ``flash_attention_bwd_dkv.launches``."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _bwd_launch(1, "flash_attention_bwd dK/dV", q, k, v, do, strides, lse,
                dvec, None, dk, dv, causal, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def bwd_operands(q, k, v, do):
    """(q, k, v, dO) as the backward kernels read them, and their 12 byte
    strides (B, heads, T of each): each itself where
    :func:`tensor_map_plan` allows (the (B, T, H, D) views attention
    passes), else an aligned contiguous copy (:func:`_in_place`). dO comes
    from autograd in whatever layout the graph gives it."""
    planned = [_in_place(t) for t in (q, k, v, do)]
    return (tuple(t for t, _ in planned),
            tuple(s for _, plan in planned for s in plan))


def _launch_bwd(q, k, v, o, lse, do, causal, scale):
    (q, k, v, do), strides = bwd_operands(q, k, v, do)
    _check_kernel(q, k, v, backward=True)
    # D = rowsum(dO * O) outside the kernels, as the reference computes it;
    # in f32 (o is widened inside the product, not copied)
    dvec = (do.float() * o).sum(-1).contiguous()
    lse = lse.float().contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, strides, lse, dvec, causal,
                                scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, strides, lse, dvec, causal,
                                     scale)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` from its inputs,
    its output ``o``, its logsumexp ``lse`` (B, H, Tq) f32 and the output
    gradient ``do``; dk/dv at the narrow (B, Hkv, Tk, D) width. CPU tensors
    take the plain version; CUDA tensors launch the dQ kernel, then the
    dK/dV kernel (:func:`flash_attention_bwd_dq`,
    :func:`flash_attention_bwd_dkv`), each counting its own launches."""
    _check(q, k, v, causal)
    b, h, tq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (b, h, tq):
        raise ValueError("flash_attention_bwd: o/do must be shaped like q "
                         "%s and lse (B, H, Tq); got %s %s %s"
                         % (tuple(q.shape), tuple(o.shape), tuple(do.shape),
                            tuple(lse.shape)))
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: o/do dtypes %s %s differ from "
                        "q's %s" % (o.dtype, do.dtype, q.dtype))
    if not (o.device == lse.device == do.device == q.device):
        raise ValueError("flash_attention_bwd: o/lse/do not on q's device")
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd: no path for device %s"
                         % q.device)
    return _launch_bwd(q, k, v, o, lse, do, causal, scale)



class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``custom_vjp``
    ``_flash``): the forward runs :func:`flash_attention` and saves its
    output and logsumexp; the backward runs :func:`flash_attention_bwd`.
    ``FlashAttention.apply(q, k, v, causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None
