"""Attention and normalization math in plain PyTorch.

Counterpart of ``mxnet_tpu/ops/attention.py``: the ``LayerNorm``,
``RMSNorm`` and ``MultiHeadAttention`` operators, rotary embedding, the
reference attention math (f32 logits and softmax whatever the input
type), the grouped-query form that never repeats K/V, the decode step's
length-masked attention over a KV cache (int8 caches widened through
their per-position scales) and the paged prefill's attention over a
cached prefix. Masked logits take ``finfo(float32).min`` as in the
reference, not ``-inf``.
"""
from __future__ import annotations

import torch

from .registry import defop

_NEG = torch.finfo(torch.float32).min


@defop("LayerNorm", arg_names=("data", "gamma", "beta"),
       param_spec={"axis": -1, "eps": 1e-5})
def _layer_norm_op(attrs, data, gamma, beta):
    """Layer normalization over ``axis`` (:func:`layer_norm`)."""
    ax = int(attrs["axis"]) % data.dim()
    x = data.movedim(ax, -1)
    return layer_norm(x, gamma, beta, attrs["eps"]).movedim(-1, ax)


@defop("RMSNorm", arg_names=("data", "gamma"),
       param_spec={"axis": -1, "eps": 1e-6})
def _rms_norm(attrs, data, gamma):
    """Root-mean-square normalization over ``axis``, no centering:
    ``x * rsqrt(mean(x^2) + eps) * gamma``."""
    ax = int(attrs["axis"]) % data.dim()
    ms = (data * data).mean(dim=ax, keepdim=True)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    return data * torch.rsqrt(ms + attrs["eps"]) * gamma.reshape(bshape)


@defop("MultiHeadAttention", arg_names=("query", "key", "value"),
       param_spec={"num_heads": 1, "num_kv_heads": 0, "causal": False,
                   "use_rope": False, "use_flash": True})
def _multi_head_attention(attrs, query, key, value):
    """Multi-head attention on (B, T, H*D) projected inputs: split heads,
    RoPE on q/k if asked, grouped-query attention (``num_kv_heads`` < heads;
    0 means MHA), merge heads. Attention always goes through the
    flash-attention function, whose backward is the flash backward; the
    port has no einsum path to select, so ``use_flash`` (the reference's
    switch, kept so graph JSON crosses between the packages) changes
    nothing."""
    from .kernels import flash_attention as _fa

    h = int(attrs["num_heads"])
    hkv = int(attrs["num_kv_heads"]) or h
    if h % hkv:
        raise ValueError("num_heads %d not divisible by num_kv_heads %d"
                         % (h, hkv))
    if query.device.type == "meta":
        # shape inference (symbol.infer_shape): nothing to compute
        return torch.empty_like(query)
    b, tq, dm = query.shape
    tk = key.shape[1]
    d = dm // h

    def split(x, t, heads):
        # (B, T, H*D) -> a (B, H, T, D) view of (B, T, H, D) storage
        return x.reshape(b, t, heads, d).transpose(1, 2)

    q = split(query, tq, h)
    k, v = split(key, tk, hkv), split(value, tk, hkv)
    if attrs["use_rope"]:
        q, k = rope(q), rope(k)
    out = _fa.FlashAttention.apply(q, k, v, bool(attrs["causal"]), None)
    return out.transpose(1, 2).reshape(b, tq, dm)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis with the population variance (as
    ``jnp.var``; torch's ``var`` defaults to the unbiased one)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def rope(x, positions=None, base=10000.0):
    """Rotary position embedding over the last axis of (..., T, D): the
    split halves rotate together (not interleaved pairs), angles in f32."""
    d = x.shape[-1]
    half = d // 2
    if positions is None:
        positions = torch.arange(x.shape[-2], device=x.device)
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freq  # (T, half)
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _causal_mask(tq, tk, device):
    """(tq, tk) bool: query i sees keys <= i + (tk - tq) — kv longer than
    q aligns the last query with the last key."""
    idx_q = torch.arange(tq, device=device)[:, None] + (tk - tq)
    return idx_q >= torch.arange(tk, device=device)[None, :]


def dot_product_attention(q, k, v, causal=False, scale=None, mask=None):
    """Reference attention math on (B, H, T, D) tensors, f32 logits."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        cmask = _causal_mask(logits.shape[-2], logits.shape[-1], q.device)
        logits = torch.where(cmask, logits, _NEG)
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def grouped_logits(q, k, hkv, causal, scale=None, mask=None):
    """f32 logits (B, Hkv, G, Tq, Tk) of q (B, H, Tq, D) grouped over k
    (B, Hkv, Tk, D); query head i reads kv head i // (H / Hkv)."""
    b, hh, tq, d = q.shape
    q5 = q.reshape(b, hkv, hh // hkv, tq, d)
    if scale is None:
        scale = 1.0 / d ** 0.5
    logits = torch.einsum("bkgqd,bkld->bkgql", q5.float(), k.float()) * scale
    if causal:
        cmask = _causal_mask(tq, logits.shape[-1], q.device)
        logits = torch.where(cmask, logits, _NEG)
    if mask is not None:
        logits = torch.where(mask[:, None, None, None, :], logits, _NEG)
    return logits


def _grouped_attention(q, k, v, hkv, causal, scale=None, mask=None):
    """GQA without materializing repeated kv. ``mask``: optional (B, Tk)
    bool of valid key positions — the decode path's per-row length mask."""
    b, hh, tq, d = q.shape
    probs = torch.softmax(grouped_logits(q, k, hkv, causal, scale, mask),
                          dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", probs.to(v.dtype), v)
    return out.reshape(b, hh, tq, d)


def dequantize_kv(cache, scale):
    """Widen an int8 KV cache view to f32 for the attention einsum:
    ``cache`` (..., Hkv, C, Dh) int8 times ``scale`` (..., C) f32, one
    scale per cached position shared across kv heads and head dim (each
    position is written once, so its scale never changes)."""
    return cache.to(torch.float32) * scale[..., None, :, None]


def cached_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None):
    """One decode step against a padded KV cache.

    ``q``: (B, H, 1, D), roped at its absolute position. ``k_cache`` /
    ``v_cache``: (B, Hkv, C, D) slot rows holding each row's keys/values
    at positions [0, lengths[i]] (the new token's already written).
    Positions past ``lengths[i]`` get exactly zero probability, so a row's
    output does not depend on stale kv elsewhere — the invariant
    continuous batching rests on. Same grouped math as prefill, Tq = 1;
    there is no kernel on this path (nor in the reference). int8 caches
    carry per-position ``k_scale`` / ``v_scale`` (B, C) and are widened
    by :func:`dequantize_kv` at the einsum input.
    """
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    cap = k_cache.shape[2]
    mask = (torch.arange(cap, device=q.device)[None, :]
            <= lengths.to(q.device)[:, None])
    return _grouped_attention(q, k_cache, v_cache, k_cache.shape[1],
                              causal=False, mask=mask)


def prefix_cached_attention(q, k_ctx, v_ctx, ctx_len, k_new, v_new,
                            k_scale=None, v_scale=None):
    """Chunked prefill against a cached prefix (the paged admit path).

    ``q``: (B, H, Tq, D), the suffix's queries roped at absolute positions
    ``ctx_len + j``. ``k_ctx`` / ``v_ctx``: (B, Hkv, C, D), the cached
    prefix, valid below ``ctx_len`` (a tensor: () or (B, 1)); every later
    position gets exactly zero probability. ``k_new`` / ``v_new``:
    (B, Hkv, Tq, D), the suffix's own keys and values, attended causally.
    With ``ctx_len == 0`` this is causal self-attention over the suffix.
    int8 prefixes carry ``k_scale`` / ``v_scale`` (B, C), widened as in
    :func:`cached_attention`; the suffix's k/v stay full precision.
    """
    if k_scale is not None:
        k_ctx = dequantize_kv(k_ctx, k_scale)
        v_ctx = dequantize_kv(v_ctx, v_scale)
    k_new = k_new.to(k_ctx.dtype)
    v_new = v_new.to(v_ctx.dtype)
    b, cap, tq = q.shape[0], k_ctx.shape[2], q.shape[2]
    k_all = torch.cat([k_ctx, k_new], dim=2)
    v_all = torch.cat([v_ctx, v_new], dim=2)
    # ctx keys valid below ctx_len; the causal term (query i aligned with
    # key cap + i) admits every ctx key and the suffix keys 0..i
    ctx_valid = (torch.arange(cap, device=q.device)[None, :]
                 < ctx_len.to(q.device)).expand(b, cap)
    mask = torch.cat([ctx_valid, torch.ones(b, tq, dtype=torch.bool,
                                             device=q.device)], dim=1)
    return _grouped_attention(q, k_all, v_all, k_ctx.shape[1], causal=True,
                              mask=mask)
