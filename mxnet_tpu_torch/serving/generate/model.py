"""Decode-side model: the KV-cache decoder LM of ``models/transformer.py``.

Counterpart of ``mxnet_tpu/serving/generate/model.py``. ``DecodeModel``
holds the weights as a dict of stacked tensors (per-layer tensors stacked
on a leading L axis) plus the head counts the weights cannot carry, and
builds the callables the generate path runs:

- ``prefill(params, tokens (1, T), length (1,))`` — causal forward over a
  bucket-padded prompt through the flash-attention kernel; returns the
  logits at ``length - 1`` and the prompt's K/V padded to slab capacity
  ``(L, 1, Hkv, C, Dh)`` (int8 KV: quantized, plus (L, 1, C) scales).
- ``decode(params, k_slab, v_slab, lengths (B,), tokens (B,))`` — one
  token for every slot: write each row's new k/v at ``lengths[i]`` in
  place, attend over its own prefix (``cached_attention``), return (B, V)
  logits.
- ``admit(k_slab, v_slab, k_new, v_new, slot)`` — slot a prefilled
  sequence's K/V into its row, in place.
- ``paged_prefill`` / ``paged_decode`` — the same over a pool of
  ``block_tokens``-position blocks addressed through block tables: the
  prefill forks a shared boundary block (copy on write), attends over
  the cached prefix gathered through the table and scatters the suffix
  into its blocks; the decode scatters each row's new k/v into its own
  block and gathers its dense view through its table.
- ``verify`` / ``paged_verify`` — speculative decoding's check: a
  (B, W) window of tokens a row at positions ``lengths[i] + j``, attending
  to the cached prefix and causally within the window, written over the
  draft's scratch positions; returns (B, W, V) logits.

int8 KV (``kv_dtype="int8"``) adds f32 scale slabs, one scale per cached
position, right after the value slabs in every signature; a position is
quantized before attention reads it, so a token's own step sees the
values every later step sees.

The reference donates the slabs to its compiled programs and takes back
the updated ones; here every callable updates the slabs in place, which
is what donation bought there (the steady-state step allocates no new
slab), and returns only what is new. A captured decode graph holds the
slab tensors it was captured on (``programs.py``).

The math follows the reference op for op: LayerNorm eps 1e-5 with the
population variance, no-bias q/k/v/o, RoPE on split halves at absolute
positions, tanh-approximate gelu (``jax.nn.gelu``'s default), biased head.
Every per-position op is row-local and the decode mask is the row's own
length, so a sequence's tokens do not depend on which other sequences
share the batch.

Weights quantized by ``mxnet_tpu_torch.quant`` (int8 or fp8-e4m3, with a
``<name>_scale`` beside each) run their products through
``ops.matrix.quantized_matmul`` with the model's ``quant_act`` strategy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ops.attention import cached_attention, prefix_cached_attention, \
    rope
from ...ops.attention import layer_norm as _ln
from ...ops.contrib import symmetric_scale
from ...ops.kernels import flash_attention as _fa
from ...ops.matrix import quantized_matmul
from ..batcher import ServingError

#: kv dtype name -> slab element type (int8's scales ride in separate f32
#: slabs, see ``kv_scale_slab_shape``)
KV_SLAB_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}
_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# stacked param -> checkpoint suffix of models/transformer.py naming
_LAYER_NAMES = {
    "ln1_g": "_ln1_gamma", "ln1_b": "_ln1_beta", "wq": "_q_weight",
    "wk": "_k_weight", "wv": "_v_weight", "wo": "_o_weight",
    "ln2_g": "_ln2_gamma", "ln2_b": "_ln2_beta", "w1": "_ffn1_weight",
    "b1": "_ffn1_bias", "w2": "_ffn2_weight", "b2": "_ffn2_bias"}
_TOP_NAMES = {"embed": "embed_weight", "lnf_g": "lnf_gamma",
              "lnf_b": "lnf_beta", "pred_w": "pred_weight",
              "pred_b": "pred_bias"}


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Architecture facts not recoverable from weight shapes."""
    num_heads: int
    num_kv_heads: int = 0  # 0 = MHA (models/transformer.py convention)
    rope_base: float = 10000.0

    @property
    def hkv(self) -> int:
        return self.num_kv_heads or self.num_heads


def _mm(params, x, name, l=None, act="int8"):
    """``x @ W.T`` with ``W = params[name]`` (``[l]`` when stacked).

    A weight that ``mxnet_tpu_torch.quant`` rewrote has a ``<name>_scale``
    sibling, and its product goes through ``quantized_matmul`` with
    ``act``'s strategy. Without one this is the plain expression, so the
    f32 paths compute exactly as without quantization."""
    w = params[name] if l is None else params[name][l]
    sname = name + "_scale"
    if sname in params:
        s = params[sname] if l is None else params[sname][l]
        return quantized_matmul(x, w, s, act_dtype=act)
    return x @ w.T


def _quantize_kv(x):
    """Per-position symmetric int8 over the (Hkv, Dh) axes:
    ``x (..., Hkv, t, Dh) -> (q int8 same shape, scale (..., t) f32)``,
    the reference's expression: ``scale = max(amax, 1e-12) / 127`` (a
    true division on the card too, ``symmetric_scale``), then
    ``clip(round(x / scale), -127, 127)`` (both round half to even)."""
    scale = symmetric_scale(x.abs().amax(dim=(-3, -1)), 127.0)
    q = torch.clamp(torch.round(x / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_SLAB_DTYPES:
        raise ServingError("decode: kv_dtype %r not yet ported (have %s)"
                           % (kv_dtype, sorted(KV_SLAB_DTYPES)),
                           code="not_ported")
    return KV_SLAB_DTYPES[kv_dtype]


def _host(v):
    """A host array of ``v`` (an NDArray's in one copy, not element by
    element)."""
    return v.asnumpy() if hasattr(v, "asnumpy") else v


def params_from_numpy(d: Dict, device=None,
                      dtype="float32") -> Dict[str, torch.Tensor]:
    """The port's stacked params from numpy weights, on ``device``.

    ``d`` is either a checkpoint-named ``arg_params`` dict
    (``models/transformer.py`` naming: embed_weight, layer%d_q_weight, ...;
    values numpy or anything with ``asnumpy()``) or the reference
    ``DecodeModel.params`` dict after ``{k: np.asarray(v)}``. The same
    numpy weights thus feed both packages; nothing is re-drawn.

    A stacked dict may be quantized (the reference's ``quant`` pass):
    int8 weights stay int8, fp8-e4m3 weights (numpy's ``float8_e4m3fn``
    of ``ml_dtypes``, which the port does not import) are read byte for
    byte, and each ``<name>_scale`` stays f32."""
    device = resolve_device(device)
    if dtype not in _PARAM_DTYPES:
        raise ServingError("decode model: dtype %r not supported (have %s)"
                           % (dtype, sorted(_PARAM_DTYPES)))

    def tensor(v, name=""):
        a = np.asarray(_host(v))
        if str(a.dtype) == "float8_e4m3fn":
            t = torch.from_numpy(np.array(a.view(np.uint8))).view(
                torch.float8_e4m3fn)
        elif a.dtype == np.int8:
            t = torch.from_numpy(np.array(a))
        else:
            # a writable copy torch may own
            t = torch.from_numpy(np.array(a, np.float32))
            if not name.endswith("_scale"):
                t = t.to(_PARAM_DTYPES[dtype])
        return t.to(device)

    if "embed_weight" not in d:
        missing = set(_LAYER_NAMES) | set(_TOP_NAMES)
        missing -= set(d)
        if missing:
            raise ServingError("decode model: params lack %s — neither "
                               "checkpoint-named nor stacked"
                               % sorted(missing))
        names = list(_LAYER_NAMES) + list(_TOP_NAMES)
        names += [n + "_scale" for n in names if n + "_scale" in d]
        return {k: tensor(d[k], k) for k in names}

    def get(name):
        if name not in d:
            raise ServingError(
                "decode model: checkpoint lacks %r — is this a "
                "models/transformer.py decoder LM?" % name)
        return d[name]

    n_layers = 0
    while ("layer%d_q_weight" % n_layers) in d:
        n_layers += 1
    if n_layers == 0:
        raise ServingError("decode model: no layer0_q_weight in params")
    params = {k: tensor(np.stack([np.asarray(
        _host(get("layer%d%s" % (i, suffix))), np.float32)
        for i in range(n_layers)]))
        for k, suffix in _LAYER_NAMES.items()}
    for k, name in _TOP_NAMES.items():
        params[k] = tensor(get(name))
    return params


class DecodeModel:
    """Stacked decoder-LM weights + derived dims.

    ``params`` (tensors on one device): embed (V, D); stacked per-layer
    ln1_g/ln1_b/ln2_g/ln2_b (L, D), wq (L, D, D), wk/wv (L, Dkv, D),
    wo (L, D, D), w1 (L, F, D), b1 (L, F), w2 (L, D, F), b2 (L, D);
    lnf_g/lnf_b (D,), pred_w (V, D), pred_b (V,). FC weights keep the
    (out, in) orientation.
    """

    def __init__(self, params: Dict[str, torch.Tensor], spec: DecodeSpec):
        self.params = params
        self.spec = spec
        # the products' strategy where params carry quantized weights
        # (set by quant.quantize_decode_model); inert without them
        self.quant_act = "int8"
        self.vocab, self.dm = params["embed"].shape
        self.layers = params["wq"].shape[0]
        self.dff = params["w1"].shape[1]
        if self.dm % spec.num_heads:
            raise ServingError("model_dim %d not divisible by num_heads %d"
                               % (self.dm, spec.num_heads))
        self.head_dim = self.dm // spec.num_heads
        want_dkv = self.head_dim * spec.hkv
        if params["wk"].shape[1] != want_dkv:
            raise ServingError(
                "k projection rows %d != num_kv_heads*head_dim %d — wrong "
                "num_heads/num_kv_heads for these weights?"
                % (params["wk"].shape[1], want_dkv))

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # --- construction ----------------------------------------------------
    @classmethod
    def from_arg_params(cls, arg_params: Dict, spec: DecodeSpec,
                        dtype="float32", device=None) -> "DecodeModel":
        """Build from ``models/transformer.py`` checkpoint naming on
        ``device`` (default: the first CUDA card; raises without one)."""
        return cls(params_from_numpy(arg_params, device, dtype), spec)

    def kv_slab_shape(self, slots: int, capacity: int) -> tuple:
        """(L, slots, Hkv, C, Dh) — one of the two KV slabs."""
        return (self.layers, slots, self.spec.hkv, capacity, self.head_dim)

    def kv_scale_slab_shape(self, slots: int, capacity: int) -> tuple:
        """(L, slots, C) — per-position f32 scales of an int8 KV slab."""
        return (self.layers, slots, capacity)

    def paged_slab_shape(self, num_blocks: int, block_tokens: int) -> tuple:
        """(L, num_blocks, Hkv, T, Dh) — one of the two paged slabs;
        ``num_blocks`` includes block 0, the trash block that inactive
        lanes and padded positions write into."""
        return (self.layers, num_blocks, self.spec.hkv, block_tokens,
                self.head_dim)

    def paged_scale_slab_shape(self, num_blocks: int,
                               block_tokens: int) -> tuple:
        """(L, num_blocks, T) — per-position f32 scales of an int8 paged
        slab (block 0 included)."""
        return (self.layers, num_blocks, block_tokens)

    # --- pieces -----------------------------------------------------------
    def _project(self, params, h, l, b, t):
        """q/k/v projections of (b, t, D) -> split-head (b, {H|Hkv}, t, Dh),
        roped later (rope needs absolute positions)."""
        s, act = self.spec, self.quant_act
        q = _mm(params, h, "wq", l, act).reshape(b, t, s.num_heads,
                                                 self.head_dim)
        k = _mm(params, h, "wk", l, act).reshape(b, t, s.hkv, self.head_dim)
        v = _mm(params, h, "wv", l, act).reshape(b, t, s.hkv, self.head_dim)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _mlp(self, params, x, l):
        act = self.quant_act
        h = _ln(x, params["ln2_g"][l], params["ln2_b"][l])
        h = F.gelu(_mm(params, h, "w1", l, act) + params["b1"][l],
                   approximate="tanh")
        return x + (_mm(params, h, "w2", l, act) + params["b2"][l])

    def _head(self, params, x):
        x = _ln(x, params["lnf_g"], params["lnf_b"])
        return _mm(params, x, "pred_w", None, self.quant_act) \
            + params["pred_b"]

    # --- the callables ----------------------------------------------------
    def build_prefill(self, bucket: int, capacity: int,
                      kv_dtype: str = "float32"):
        """fn(params, tokens (1, T=bucket) int, length (1,) int) ->
        (logits (1, V), k, v (L, 1, Hkv, C, Dh) of ``kv_dtype``). Padded
        positions >= length produce kv that decode never reads (masked by
        length); the causal mask keeps them out of the returned logits.
        ``kv_dtype`` re-types the returned cache only: bf16 casts, int8
        quantizes per position (after the flash kernel, which runs in the
        model's type) and appends the (L, 1, C) k and v scales."""
        if bucket > capacity:
            raise ServingError("prefill bucket %d exceeds kv capacity %d"
                               % (bucket, capacity))
        elem = _kv_dtype(kv_dtype)
        spec = self.spec

        def prefill(params, tokens, length):
            x = params["embed"][tokens.long()]                # (1, T, D)
            kv_shape = self.kv_slab_shape(1, capacity)
            wide = x.dtype if elem == torch.int8 else elem
            k_out = torch.zeros(kv_shape, dtype=wide, device=x.device)
            v_out = torch.zeros(kv_shape, dtype=wide, device=x.device)
            for l in range(self.layers):
                h = _ln(x, params["ln1_g"][l], params["ln1_b"][l])
                q, k, v = self._project(params, h, l, 1, bucket)
                q = rope(q, base=spec.rope_base)
                k = rope(k, base=spec.rope_base)
                # where the reference calls the Pallas flash kernel
                # (model.py:253-254); on CUDA this is the CUDA kernel
                att = _fa.flash_attention(q, k, v, causal=True)
                x = self._attend_rest(params, x, att, l)
                k_out[l, :, :, :bucket] = k
                v_out[l, :, :, :bucket] = v
            # the head is row-local: run it on the one row that is returned
            last = x[torch.arange(1, device=x.device), length.long() - 1]
            logits = self._head(params, last)
            if elem == torch.int8:
                kq, k_s = _quantize_kv(k_out)            # scales (L, 1, C)
                vq, v_s = _quantize_kv(v_out)
                return logits, kq, vq, k_s, v_s
            return logits, k_out, v_out

        return prefill

    def _check_slab(self, what, slab, shape, elem):
        if slab.dtype != elem or tuple(slab.shape) != shape:
            raise ServingError("%s: slab %s %s, want %s %s"
                               % (what, tuple(slab.shape), slab.dtype,
                                  shape, elem))

    def _step_layer(self, params, x, l, pos):
        """One layer's q and new k/v for a (B, D) step at rope positions
        ``pos`` (B, 1, 1), or a (B, W, D) window at positions (B, 1, W):
        q (B, H, t, Dh), k_t, v_t (B, Hkv, t, Dh), t = 1 or W."""
        spec = self.spec
        b, t = x.shape[0], (1 if x.dim() == 2 else x.shape[1])
        h = _ln(x, params["ln1_g"][l], params["ln1_b"][l])
        q, k_t, v_t = self._project(params, h, l, b, t)
        q = rope(q, positions=pos, base=spec.rope_base)
        k_t = rope(k_t, positions=pos, base=spec.rope_base)
        return q, k_t, v_t

    def _attend_rest(self, params, x, att, l):
        """The layer after attention: ``att`` (B, H, t, Dh) merged to x's
        (B, [t,] D), the o projection, the residual and the MLP."""
        att = att.transpose(1, 2).reshape(*x.shape[:-1], self.dm)
        x = x + _mm(params, att.to(x.dtype), "wo", l, self.quant_act)
        return self._mlp(params, x, l)

    def build_decode(self, slots: int, capacity: int,
                     kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, lengths (B,), tokens (B,)) ->
        logits (B, V), the slabs updated in place; int8 KV takes the scale
        slabs (L, B, C) after the value slabs: fn(params, k_slab, v_slab,
        ks_slab, vs_slab, lengths, tokens). Inactive slots run with
        lengths pinned to 0 — wasted lanes, never wrong lanes. bf16 slabs
        take cast writes, int8 slabs quantized ones (each new position
        before attention reads it); reads go through the f32 attention
        math. Nothing here waits for the device or reads a tensor's value
        on the host, so the step can be captured as a CUDA graph."""
        elem = _kv_dtype(kv_dtype)
        shape = self.kv_slab_shape(slots, capacity)
        sshape = self.kv_scale_slab_shape(slots, capacity)

        def body(params, k_slab, v_slab, ks_slab, vs_slab, lengths, tokens):
            self._check_slab("decode", k_slab, shape, elem)
            self._check_slab("decode", v_slab, shape, elem)
            lengths = lengths.long()
            x = params["embed"][tokens.long()]                # (B, D)
            # rope positions: the new token sits at index `length`
            pos = lengths.reshape(slots, 1, 1)
            rows = torch.arange(slots, device=x.device)
            for l in range(self.layers):
                q, k_t, v_t = self._step_layer(params, x, l, pos)
                k_l, v_l = k_slab[l], v_slab[l]               # views
                # each row's k/v lands at its own position lengths[i]
                if ks_slab is None:
                    k_l[rows, :, lengths] = k_t[:, :, 0].to(elem)
                    v_l[rows, :, lengths] = v_t[:, :, 0].to(elem)
                    att = cached_attention(q, k_l, v_l, lengths)
                else:
                    kq, k_s = _quantize_kv(k_t)               # scales (B, 1)
                    vq, v_s = _quantize_kv(v_t)
                    k_l[rows, :, lengths] = kq[:, :, 0]
                    v_l[rows, :, lengths] = vq[:, :, 0]
                    ks_l, vs_l = ks_slab[l], vs_slab[l]
                    ks_l[rows, lengths] = k_s[:, 0]
                    vs_l[rows, lengths] = v_s[:, 0]
                    att = cached_attention(q, k_l, v_l, lengths,
                                           k_scale=ks_l, v_scale=vs_l)
                x = self._attend_rest(params, x, att, l)
            return self._head(params, x)

        if elem == torch.int8:
            def decode(params, k_slab, v_slab, ks_slab, vs_slab, lengths,
                       tokens):
                self._check_slab("decode", ks_slab, sshape, torch.float32)
                self._check_slab("decode", vs_slab, sshape, torch.float32)
                return body(params, k_slab, v_slab, ks_slab, vs_slab,
                            lengths, tokens)
        else:
            def decode(params, k_slab, v_slab, lengths, tokens):
                return body(params, k_slab, v_slab, None, None, lengths,
                            tokens)

        return decode

    def build_admit(self, slots: int, capacity: int,
                    kv_dtype: str = "float32"):
        """fn(k_slab, v_slab, k_new (L, 1, Hkv, C, Dh), v_new, slot):
        overwrites row ``slot`` of the slabs in place; int8 KV:
        fn(k_slab, v_slab, ks_slab, vs_slab, k_new, v_new, ks_new, vs_new,
        slot), the (L, 1, C) scale rows beside the values."""
        elem = _kv_dtype(kv_dtype)

        def row(slot):
            slot = int(slot)
            if not 0 <= slot < slots:
                raise ServingError("admit: slot %d out of range [0, %d)"
                                   % (slot, slots))
            return slot

        if elem == torch.int8:
            def admit(k_slab, v_slab, ks_slab, vs_slab, k_new, v_new,
                      ks_new, vs_new, slot):
                slot = row(slot)
                k_slab[:, slot] = k_new[:, 0]
                v_slab[:, slot] = v_new[:, 0]
                ks_slab[:, slot] = ks_new[:, 0]
                vs_slab[:, slot] = vs_new[:, 0]
        else:
            def admit(k_slab, v_slab, k_new, v_new, slot):
                slot = row(slot)
                k_slab[:, slot] = k_new[:, 0]
                v_slab[:, slot] = v_new[:, 0]

        return admit

    def build_paged_prefill(self, bucket: int, block_tokens: int,
                            max_blocks: int, kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, table (MB,), ctx_len (), tokens
        (1, T=bucket), n (1,), fork_src (), fork_dst ()) -> logits (1, V),
        the slabs (L, NB, Hkv, T, Dh) updated in place; int8 KV takes the
        scale slabs (L, NB, T) after the value slabs. Integer arguments are
        tensors. One callable does what the reference's program does:

        1. **copy-on-write fork**: block ``fork_src`` is copied into
           ``fork_dst`` (both 0, the trash block, when there is no fork),
           so a suffix that diverges inside a shared block writes a
           private copy while every other sharer reads the original;
        2. **chunked prefill over the cached prefix**: the first
           ``ctx_len`` positions are gathered through ``table``; the ``n``
           suffix tokens, roped at ``ctx_len + j``, attend to them and
           causally to each other (``prefix_cached_attention``);
        3. **admit**: suffix position j's k/v goes to block
           ``table[(ctx_len + j) // T]`` at offset ``(ctx_len + j) % T``;
           padded positions (j >= n) go to the trash block.

        int8: the fork copies scale blocks with value blocks, the prefix
        widens through its scales, and the suffix is stored quantized.
        Attention here is the reference's einsum (its paged prefill runs
        no Pallas kernel), so the flash kernel is not launched."""
        elem = _kv_dtype(kv_dtype)
        spec = self.spec
        T, mb = int(block_tokens), int(max_blocks)
        cap = T * mb

        def body(params, k_slab, v_slab, ks_slab, vs_slab, table, ctx_len,
                 tokens, n, fork_src, fork_dst):
            dev = k_slab.device
            table = table.long()
            ctx_len = ctx_len.long()
            # (1) CoW fork, before anything reads through the table (whose
            # boundary entry already names fork_dst)
            src, dst = fork_src.long().reshape(1), fork_dst.long().reshape(1)
            for slab in (k_slab, v_slab, ks_slab, vs_slab):
                if slab is not None:
                    slab.index_copy_(1, dst, slab.index_select(1, src))
            x = params["embed"][tokens.long()]                # (1, T, D)
            j = torch.arange(bucket, device=dev)
            pos = ctx_len + j                                 # absolute
            phys = torch.where(j < n.long()[0],
                               table[torch.clamp(pos // T, 0, mb - 1)],
                               torch.zeros_like(j))
            off = pos % T
            hkv, hd = spec.hkv, self.head_dim
            for l in range(self.layers):
                h = _ln(x, params["ln1_g"][l], params["ln1_b"][l])
                q, k, v = self._project(params, h, l, 1, bucket)
                q = rope(q, positions=pos, base=spec.rope_base)
                k = rope(k, positions=pos, base=spec.rope_base)
                # (2) the cached prefix, gathered through the block table
                k_ctx = k_slab[l][table].transpose(0, 1).reshape(
                    1, hkv, cap, hd)
                v_ctx = v_slab[l][table].transpose(0, 1).reshape(
                    1, hkv, cap, hd)
                if ks_slab is None:
                    att = prefix_cached_attention(q, k_ctx, v_ctx, ctx_len,
                                                  k, v)
                else:
                    att = prefix_cached_attention(
                        q, k_ctx, v_ctx, ctx_len, k, v,
                        k_scale=ks_slab[l][table].reshape(1, cap),
                        v_scale=vs_slab[l][table].reshape(1, cap))
                x = self._attend_rest(params, x, att, l)
                # (3) admit: this layer's suffix k/v into its blocks
                if ks_slab is None:
                    k_slab[l, phys, :, off] = k[0].transpose(0, 1).to(elem)
                    v_slab[l, phys, :, off] = v[0].transpose(0, 1).to(elem)
                else:
                    kq, k_s = _quantize_kv(k)          # scales (1, bucket)
                    vq, v_s = _quantize_kv(v)
                    k_slab[l, phys, :, off] = kq[0].transpose(0, 1)
                    v_slab[l, phys, :, off] = vq[0].transpose(0, 1)
                    ks_slab[l, phys, off] = k_s[0]
                    vs_slab[l, phys, off] = v_s[0]
            last = x[torch.arange(1, device=dev), n.long() - 1]
            return self._head(params, last)

        if elem == torch.int8:
            def prefill(params, k_slab, v_slab, ks_slab, vs_slab, table,
                        ctx_len, tokens, n, fork_src, fork_dst):
                return body(params, k_slab, v_slab, ks_slab, vs_slab, table,
                            ctx_len, tokens, n, fork_src, fork_dst)
        else:
            def prefill(params, k_slab, v_slab, table, ctx_len, tokens, n,
                        fork_src, fork_dst):
                return body(params, k_slab, v_slab, None, None, table,
                            ctx_len, tokens, n, fork_src, fork_dst)

        return prefill

    def build_paged_decode(self, slots: int, block_tokens: int,
                           max_blocks: int, kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, tables (B, MB), lengths (B,), tokens
        (B,)) -> logits (B, V), the slabs updated in place; int8 KV takes
        the scale slabs after the value slabs.

        The paged twin of ``build_decode``: row i's new k/v goes to block
        ``tables[i, lengths[i] // T]`` at offset ``lengths[i] % T`` (a
        block private to row i: copy-on-write resolved sharing at
        admission), then attention gathers the row's dense (Hkv, MB*T, Dh)
        view through its table and masks by length. Inactive lanes carry
        an all-zero table, so they write the trash block. Capturable, as
        ``build_decode``."""
        elem = _kv_dtype(kv_dtype)
        spec = self.spec
        T, mb = int(block_tokens), int(max_blocks)
        cap = T * mb

        def body(params, k_slab, v_slab, ks_slab, vs_slab, tables, lengths,
                 tokens):
            if k_slab.dtype != elem or v_slab.dtype != elem:
                raise ServingError("paged decode: slabs %s, want %s"
                                   % (k_slab.dtype, elem))
            hkv, hd = spec.hkv, self.head_dim
            lengths = lengths.long()
            tables = tables.long()
            x = params["embed"][tokens.long()]                # (B, D)
            pos = lengths.reshape(slots, 1, 1)
            # write site per row: its own block
            phys_w = tables.gather(
                1, torch.clamp(lengths // T, 0, mb - 1)[:, None])[:, 0]
            off_w = lengths % T
            for l in range(self.layers):
                q, k_t, v_t = self._step_layer(params, x, l, pos)
                if ks_slab is None:
                    k_slab[l, phys_w, :, off_w] = k_t[:, :, 0].to(elem)
                    v_slab[l, phys_w, :, off_w] = v_t[:, :, 0].to(elem)
                else:
                    kq, k_s = _quantize_kv(k_t)               # scales (B, 1)
                    vq, v_s = _quantize_kv(v_t)
                    k_slab[l, phys_w, :, off_w] = kq[:, :, 0]
                    v_slab[l, phys_w, :, off_w] = vq[:, :, 0]
                    ks_slab[l, phys_w, off_w] = k_s[:, 0]
                    vs_slab[l, phys_w, off_w] = v_s[:, 0]
                # each row's dense view, after the write: the new token's
                # k/v is visible to its own attention
                k_l = k_slab[l][tables].transpose(1, 2).reshape(
                    slots, hkv, cap, hd)
                v_l = v_slab[l][tables].transpose(1, 2).reshape(
                    slots, hkv, cap, hd)
                if ks_slab is None:
                    att = cached_attention(q, k_l, v_l, lengths)
                else:
                    att = cached_attention(
                        q, k_l, v_l, lengths,
                        k_scale=ks_slab[l][tables].reshape(slots, cap),
                        v_scale=vs_slab[l][tables].reshape(slots, cap))
                x = self._attend_rest(params, x, att, l)
            return self._head(params, x)

        if elem == torch.int8:
            def decode(params, k_slab, v_slab, ks_slab, vs_slab, tables,
                       lengths, tokens):
                return body(params, k_slab, v_slab, ks_slab, vs_slab, tables,
                            lengths, tokens)
        else:
            def decode(params, k_slab, v_slab, tables, lengths, tokens):
                return body(params, k_slab, v_slab, None, None, tables,
                            lengths, tokens)

        return decode

    # --- speculative decoding's verify ------------------------------------
    def build_verify(self, slots: int, capacity: int, window: int,
                     kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, lengths (B,), wtokens (B, W)) ->
        logits (B, W, V), the slabs updated in place; int8 KV takes the
        scale slabs after the value slabs. The verify of speculative
        decoding (``spec.py``).

        ``wtokens[i] = [last_token, d_1 .. d_k]`` (W = k + 1) sit at
        positions ``lengths[i] + j``; each attends to the row's cached
        prefix (masked by ``lengths[i]``, so the draft steps' scratch
        writes are invisible) and causally to the earlier window
        positions, and every window position's k/v is written into the
        slab over the draft's, so a rewind is a host-side length edit.
        ``logits[i, j]`` is the model's next-token distribution after
        position ``lengths[i] + j``.

        Positions at or past capacity are dropped (the reference's
        ``mode="drop"``). The write covers W positions a row that all lie
        below capacity, from ``min(lengths[i], capacity - W)``: each takes
        its window lane's value where it is at or past ``lengths[i]`` and
        keeps its own value before, so no two lanes write one position
        and a lane past capacity writes nothing. int8: each window
        position is quantized as the decode step quantizes it, and the
        window attends to its quantized-then-widened values, the bytes
        every later step reads."""
        elem = _kv_dtype(kv_dtype)
        W = int(window)
        if W > capacity:
            raise ServingError("verify window %d exceeds kv capacity %d"
                               % (W, capacity))
        shape = self.kv_slab_shape(slots, capacity)
        sshape = self.kv_scale_slab_shape(slots, capacity)

        def body(params, k_slab, v_slab, ks_slab, vs_slab, lengths, wtokens):
            self._check_slab("verify", k_slab, shape, elem)
            self._check_slab("verify", v_slab, shape, elem)
            dev = k_slab.device
            lengths = lengths.long()
            x = params["embed"][wtokens.long()]              # (B, W, D)
            lanes = torch.arange(W, device=dev)
            pos = lengths[:, None] + lanes                     # (B, W)
            rows = torch.arange(slots, device=dev)[:, None]    # (B, 1)
            site = torch.clamp(lengths, max=capacity - W)[:, None] + lanes
            fresh = site >= lengths[:, None]
            lane = torch.clamp(site - lengths[:, None], min=0)

            def write(slab_l, new):
                # slab_l (B, Hkv, C, Dh) with new (B, Hkv, W, Dh), or the
                # scales (B, C) with new (B, W)
                if slab_l.dim() == 2:
                    old, upd = slab_l[rows, site], new[rows, lane]
                    slab_l[rows, site] = torch.where(fresh, upd, old)
                else:
                    old = slab_l[rows, :, site]          # (B, W, Hkv, Dh)
                    upd = new.transpose(1, 2)[rows, lane]
                    slab_l[rows, :, site] = torch.where(
                        fresh[..., None, None], upd, old)

            for l in range(self.layers):
                q, k_t, v_t = self._step_layer(params, x, l, pos[:, None])
                k_l, v_l = k_slab[l], v_slab[l]                # views
                if ks_slab is None:
                    k_win, v_win = k_t.to(elem), v_t.to(elem)
                    write(k_l, k_win)
                    write(v_l, v_win)
                    att = prefix_cached_attention(
                        q, k_l, v_l, lengths[:, None], k_win, v_win)
                else:
                    kq, k_s = _quantize_kv(k_t)               # scales (B, W)
                    vq, v_s = _quantize_kv(v_t)
                    ks_l, vs_l = ks_slab[l], vs_slab[l]
                    write(k_l, kq)
                    write(v_l, vq)
                    write(ks_l, k_s)
                    write(vs_l, v_s)
                    k_win = kq.to(torch.float32) * k_s[:, None, :, None]
                    v_win = vq.to(torch.float32) * v_s[:, None, :, None]
                    att = prefix_cached_attention(
                        q, k_l, v_l, lengths[:, None], k_win, v_win,
                        k_scale=ks_l, v_scale=vs_l)
                x = self._attend_rest(params, x, att, l)
            return self._head(params, x)

        if elem == torch.int8:
            def verify(params, k_slab, v_slab, ks_slab, vs_slab, lengths,
                       wtokens):
                self._check_slab("verify", ks_slab, sshape, torch.float32)
                self._check_slab("verify", vs_slab, sshape, torch.float32)
                return body(params, k_slab, v_slab, ks_slab, vs_slab,
                            lengths, wtokens)
        else:
            def verify(params, k_slab, v_slab, lengths, wtokens):
                return body(params, k_slab, v_slab, None, None, lengths,
                            wtokens)

        return verify

    def build_paged_verify(self, slots: int, block_tokens: int,
                           max_blocks: int, window: int,
                           kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, tables (B, MB), lengths (B,), wtokens
        (B, W)) -> logits (B, W, V), the slabs updated in place; int8 KV
        takes the scale slabs after the value slabs. The paged twin of
        :meth:`build_verify`: window position ``lengths[i] + j`` goes to
        block ``tables[i, (lengths[i] + j) // T]`` at offset ``% T``;
        positions at or past capacity, and those past the row's
        reservation (table entry 0), go to the trash block, which is never
        read unmasked. The admission reservation covers every position a
        stream can commit, so accepted tokens land in reserved private
        blocks and a rewind stays a length edit
        (``PagedKVCacheManager.truncate``)."""
        elem = _kv_dtype(kv_dtype)
        spec = self.spec
        T, mb = int(block_tokens), int(max_blocks)
        cap = T * mb
        W = int(window)

        def body(params, k_slab, v_slab, ks_slab, vs_slab, tables, lengths,
                 wtokens):
            if k_slab.dtype != elem or v_slab.dtype != elem:
                raise ServingError("paged verify: slabs %s, want %s"
                                   % (k_slab.dtype, elem))
            hkv, hd = spec.hkv, self.head_dim
            dev = k_slab.device
            lengths = lengths.long()
            tables = tables.long()
            x = params["embed"][wtokens.long()]              # (B, W, D)
            pos = lengths[:, None] + torch.arange(W, device=dev)  # (B, W)
            # a position past capacity must not wrap onto a real block:
            # clamping its table index would, so it goes to trash
            phys = torch.where(
                pos < cap,
                tables.gather(1, torch.clamp(pos // T, 0, mb - 1)),
                torch.zeros_like(pos))
            off = pos % T
            for l in range(self.layers):
                q, k_t, v_t = self._step_layer(params, x, l, pos[:, None])
                if ks_slab is None:
                    k_win, v_win = k_t.to(elem), v_t.to(elem)
                    k_slab[l, phys, :, off] = k_win.transpose(1, 2)
                    v_slab[l, phys, :, off] = v_win.transpose(1, 2)
                else:
                    kq, k_s = _quantize_kv(k_t)               # scales (B, W)
                    vq, v_s = _quantize_kv(v_t)
                    k_slab[l, phys, :, off] = kq.transpose(1, 2)
                    v_slab[l, phys, :, off] = vq.transpose(1, 2)
                    ks_slab[l, phys, off] = k_s
                    vs_slab[l, phys, off] = v_s
                    k_win = kq.to(torch.float32) * k_s[:, None, :, None]
                    v_win = vq.to(torch.float32) * v_s[:, None, :, None]
                # each row's dense view through its table (after the write,
                # as the paged decode; the window is masked by lengths)
                k_l = k_slab[l][tables].transpose(1, 2).reshape(
                    slots, hkv, cap, hd)
                v_l = v_slab[l][tables].transpose(1, 2).reshape(
                    slots, hkv, cap, hd)
                if ks_slab is None:
                    att = prefix_cached_attention(
                        q, k_l, v_l, lengths[:, None], k_win, v_win)
                else:
                    att = prefix_cached_attention(
                        q, k_l, v_l, lengths[:, None], k_win, v_win,
                        k_scale=ks_slab[l][tables].reshape(slots, cap),
                        v_scale=vs_slab[l][tables].reshape(slots, cap))
                x = self._attend_rest(params, x, att, l)
            return self._head(params, x)

        if elem == torch.int8:
            def verify(params, k_slab, v_slab, ks_slab, vs_slab, tables,
                       lengths, wtokens):
                return body(params, k_slab, v_slab, ks_slab, vs_slab, tables,
                            lengths, wtokens)
        else:
            def verify(params, k_slab, v_slab, tables, lengths, wtokens):
                return body(params, k_slab, v_slab, None, None, tables,
                            lengths, wtokens)

        return verify
