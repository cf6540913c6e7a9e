"""Decode-side model: the KV-cache decoder LM of ``models/transformer.py``.

Counterpart of ``mxnet_tpu/serving/generate/model.py``. ``DecodeModel``
holds the weights as a dict of stacked tensors (per-layer tensors stacked
on a leading L axis) plus the head counts the weights cannot carry, and
builds the callables the generate path runs:

- ``prefill(params, tokens (1, T), length (1,))`` — causal forward over a
  bucket-padded prompt through the flash-attention kernel; returns the
  logits at ``length - 1`` and the prompt's K/V padded to slab capacity
  ``(L, 1, Hkv, C, Dh)``.
- ``decode(params, k_slab, v_slab, lengths (B,), tokens (B,))`` — one
  token for every slot: write each row's new k/v at ``lengths[i]`` in
  place, attend over its own prefix (``cached_attention``), return (B, V)
  logits.
- ``admit(k_slab, v_slab, k_new, v_new, slot)`` — slot a prefilled
  sequence's K/V into its row, in place.

The reference donates the slabs to its compiled programs and takes back
the updated ones; here the decode and admit callables update the slabs in
place, which is what donation bought there (the steady-state step
allocates no new slab), so they return no slabs.

The math follows the reference op for op: LayerNorm eps 1e-5 with the
population variance, no-bias q/k/v/o, RoPE on split halves at absolute
positions, tanh-approximate gelu (``jax.nn.gelu``'s default), biased head.
Every per-position op is row-local and the decode mask is the row's own
length, so a sequence's tokens do not depend on which other sequences
share the batch. The paged, verify and int8 programs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ops.attention import cached_attention, rope
from ...ops.attention import layer_norm as _ln
from ...ops.kernels import flash_attention as _fa
from ..batcher import ServingError

#: kv dtype name -> slab element type (int8 is not ported yet)
KV_SLAB_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
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


def _mm(params, x, name, l=None):
    """``x @ W.T`` with ``W = params[name]`` (``[l]`` when stacked)."""
    w = params[name] if l is None else params[name][l]
    return x @ w.T


def _kv_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_SLAB_DTYPES:
        raise ServingError("decode: kv_dtype %r not yet ported (have %s)"
                           % (kv_dtype, sorted(KV_SLAB_DTYPES)),
                           code="not_ported")
    return KV_SLAB_DTYPES[kv_dtype]


def params_from_numpy(d: Dict, device=None,
                      dtype="float32") -> Dict[str, torch.Tensor]:
    """The port's stacked params from numpy weights, on ``device``.

    ``d`` is either a checkpoint-named ``arg_params`` dict
    (``models/transformer.py`` naming: embed_weight, layer%d_q_weight, ...;
    values numpy or anything with ``asnumpy()``) or the reference
    ``DecodeModel.params`` dict after ``{k: np.asarray(v)}``. The same
    numpy weights thus feed both packages; nothing is re-drawn."""
    device = resolve_device(device)
    if dtype not in _PARAM_DTYPES:
        raise ServingError("decode model: dtype %r not supported (have %s)"
                           % (dtype, sorted(_PARAM_DTYPES)))

    def tensor(v):
        v = v.asnumpy() if hasattr(v, "asnumpy") else v
        a = np.array(v, np.float32)    # a writable copy torch may own
        return torch.from_numpy(a).to(device=device,
                                      dtype=_PARAM_DTYPES[dtype])

    if "embed_weight" not in d:
        missing = set(_LAYER_NAMES) | set(_TOP_NAMES)
        missing -= set(d)
        if missing:
            raise ServingError("decode model: params lack %s — neither "
                               "checkpoint-named nor stacked"
                               % sorted(missing))
        return {k: tensor(d[k]) for k in list(_LAYER_NAMES) + list(
            _TOP_NAMES)}

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
        get("layer%d%s" % (i, suffix)), np.float32)
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

    # --- pieces -----------------------------------------------------------
    def _project(self, params, h, l, b, t):
        """q/k/v projections of (b, t, D) -> split-head (b, {H|Hkv}, t, Dh),
        roped later (rope needs absolute positions)."""
        s = self.spec
        q = _mm(params, h, "wq", l).reshape(b, t, s.num_heads, self.head_dim)
        k = _mm(params, h, "wk", l).reshape(b, t, s.hkv, self.head_dim)
        v = _mm(params, h, "wv", l).reshape(b, t, s.hkv, self.head_dim)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    @staticmethod
    def _mlp(params, x, l):
        h = _ln(x, params["ln2_g"][l], params["ln2_b"][l])
        h = F.gelu(_mm(params, h, "w1", l) + params["b1"][l],
                   approximate="tanh")
        return x + (_mm(params, h, "w2", l) + params["b2"][l])

    @staticmethod
    def _head(params, x):
        x = _ln(x, params["lnf_g"], params["lnf_b"])
        return _mm(params, x, "pred_w") + params["pred_b"]

    # --- the callables ----------------------------------------------------
    def build_prefill(self, bucket: int, capacity: int,
                      kv_dtype: str = "float32"):
        """fn(params, tokens (1, T=bucket) int, length (1,) int) ->
        (logits (1, V), k, v (L, 1, Hkv, C, Dh) of ``kv_dtype``). Padded
        positions >= length produce kv that decode never reads (masked by
        length); the causal mask keeps them out of the returned logits.
        ``kv_dtype`` re-types the returned cache only."""
        if bucket > capacity:
            raise ServingError("prefill bucket %d exceeds kv capacity %d"
                               % (bucket, capacity))
        elem = _kv_dtype(kv_dtype)
        spec = self.spec

        def prefill(params, tokens, length):
            x = params["embed"][tokens.long()]                # (1, T, D)
            kv_shape = self.kv_slab_shape(1, capacity)
            k_out = torch.zeros(kv_shape, dtype=elem, device=x.device)
            v_out = torch.zeros(kv_shape, dtype=elem, device=x.device)
            for l in range(self.layers):
                h = _ln(x, params["ln1_g"][l], params["ln1_b"][l])
                q, k, v = self._project(params, h, l, 1, bucket)
                q = rope(q, base=spec.rope_base)
                k = rope(k, base=spec.rope_base)
                # where the reference calls the Pallas flash kernel
                # (model.py:253-254); on CUDA this is the CUDA kernel
                att = _fa.flash_attention(q, k, v, causal=True)
                att = att.transpose(1, 2).reshape(1, bucket, self.dm)
                x = x + _mm(params, att.to(x.dtype), "wo", l)
                x = self._mlp(params, x, l)
                k_out[l, :, :, :bucket] = k
                v_out[l, :, :, :bucket] = v
            # the head is row-local: run it on the one row that is returned
            last = x[torch.arange(1, device=x.device), length.long() - 1]
            return self._head(params, last), k_out, v_out

        return prefill

    def build_decode(self, slots: int, capacity: int,
                     kv_dtype: str = "float32"):
        """fn(params, k_slab, v_slab, lengths (B,), tokens (B,)) ->
        logits (B, V), the slabs updated in place.
        Inactive slots run with lengths pinned to 0 — wasted lanes, never
        wrong lanes. bf16 slabs take cast writes; reads go through the
        f32 attention math."""
        elem = _kv_dtype(kv_dtype)
        spec = self.spec
        hd = self.head_dim

        def decode(params, k_slab, v_slab, lengths, tokens):
            if k_slab.dtype != elem or k_slab.shape != self.kv_slab_shape(
                    slots, capacity):
                raise ServingError("decode: slab %s %s, want %s %s"
                                   % (tuple(k_slab.shape), k_slab.dtype,
                                      self.kv_slab_shape(slots, capacity),
                                      elem))
            lengths = lengths.long()
            x = params["embed"][tokens.long()]                # (B, D)
            # rope positions: the new token sits at index `length`
            pos = lengths.reshape(slots, 1, 1)
            rows = torch.arange(slots, device=x.device)
            for l in range(self.layers):
                h = _ln(x, params["ln1_g"][l], params["ln1_b"][l])
                q = _mm(params, h, "wq", l).reshape(slots, spec.num_heads,
                                                    1, hd)
                k_t = _mm(params, h, "wk", l).reshape(slots, spec.hkv, 1, hd)
                v_t = _mm(params, h, "wv", l).reshape(slots, spec.hkv, 1, hd)
                q = rope(q, positions=pos, base=spec.rope_base)
                k_t = rope(k_t, positions=pos, base=spec.rope_base)
                k_l, v_l = k_slab[l], v_slab[l]               # views
                # each row's k/v lands at its own position lengths[i]
                k_l[rows, :, lengths] = k_t[:, :, 0].to(elem)
                v_l[rows, :, lengths] = v_t[:, :, 0].to(elem)
                att = cached_attention(q, k_l, v_l, lengths)
                att = att.transpose(1, 2).reshape(slots, self.dm)
                x = x + _mm(params, att.to(x.dtype), "wo", l)
                x = self._mlp(params, x, l)
            return self._head(params, x)

        return decode

    def build_admit(self, slots: int, capacity: int,
                    kv_dtype: str = "float32"):
        """fn(k_slab, v_slab, k_new (L, 1, Hkv, C, Dh), v_new, slot):
        overwrites row ``slot`` of the slabs in place."""
        _kv_dtype(kv_dtype)

        def admit(k_slab, v_slab, k_new, v_new, slot):
            slot = int(slot)
            if not 0 <= slot < slots:
                raise ServingError("admit: slot %d out of range [0, %d)"
                                   % (slot, slots))
            k_slab[:, slot] = k_new[:, 0]
            v_slab[:, slot] = v_new[:, 0]

        return admit
