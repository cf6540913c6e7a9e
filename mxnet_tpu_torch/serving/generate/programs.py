"""The fixed-shape program set for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/generate/programs.py``'s
``DecodePrograms``. The reference compiles one XLA program per prompt
bucket, one decode step and one admit, and caches them on disk. PyTorch
runs eagerly, so here a "program" is the callable ``DecodeModel`` builds;
the set keeps the reference's shape discipline (prompts padded to the
bucket ladder, one fixed-shape step over all slots), which is also what a
later CUDA-graph capture needs. There is no program cache and no compile
witness.

The reference donates the slabs to the step and admit programs and
adopts the slabs they return; here those callables update the slabs in
place and return none, so the steady-state step allocates only its
logits.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batcher import ServingError
from .model import KV_SLAB_DTYPES, DecodeModel


class DecodePrograms:
    """The program set for one model at one slot/capacity config.

    Construction and ``ensure_prefill``'s lazy per-bucket build happen on
    the scheduler thread; the callables run on the engine worker.
    """

    def __init__(self, model: DecodeModel, slots: int, capacity: int,
                 prefill_buckets: Sequence[int],
                 kv_dtype: str = "float32"):
        buckets = sorted({int(b) for b in prefill_buckets})
        if not buckets:
            raise ServingError("decode: empty prefill bucket ladder")
        if buckets[-1] > capacity:
            raise ServingError(
                "decode: prefill bucket %d exceeds kv capacity %d"
                % (buckets[-1], capacity))
        if kv_dtype not in KV_SLAB_DTYPES:
            raise ServingError("decode: kv_dtype %r not yet ported (have %s)"
                               % (kv_dtype, sorted(KV_SLAB_DTYPES)),
                               code="not_ported")
        self.model = model
        self.device = model.device
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.buckets: List[int] = buckets
        self.kv_dtype = kv_dtype
        self._prefill: Dict[int, Callable] = {}
        self._decode = model.build_decode(self.slots, self.capacity, kv_dtype)
        self._admit = model.build_admit(self.slots, self.capacity, kv_dtype)

    # --- shapes -----------------------------------------------------------
    def fresh_slabs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = self.model.kv_slab_shape(self.slots, self.capacity)
        elem = KV_SLAB_DTYPES[self.kv_dtype]
        return (torch.zeros(shape, dtype=elem, device=self.device),
                torch.zeros(shape, dtype=elem, device=self.device))

    def kv_bytes(self) -> int:
        """Bytes in the K+V slabs."""
        shape = self.model.kv_slab_shape(self.slots, self.capacity)
        elem = KV_SLAB_DTYPES[self.kv_dtype].itemsize
        return 2 * int(np.prod(shape)) * elem

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Smallest ladder bucket holding the prompt, or None (too long)."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return None

    def ensure_prefill(self, prompt_len: int):
        """Build (or no-op) the bucket program for ``prompt_len`` on the
        calling thread, so engine workers only run built programs."""
        bucket = self.bucket_for(prompt_len)
        if bucket is not None:
            self._prefill_for(bucket)

    def _prefill_for(self, bucket: int) -> Callable:
        prog = self._prefill.get(bucket)
        if prog is None:
            prog = self.model.build_prefill(bucket, self.capacity,
                                            self.kv_dtype)
            self._prefill[bucket] = prog
        return prog

    # --- execution --------------------------------------------------------
    def prefill(self, token_ids: Sequence[int]):
        """Run one prompt through its bucket's prefill program.
        Returns (last_logits (V,), k_new, v_new (L, 1, Hkv, C, Dh))."""
        n = len(token_ids)
        bucket = self.bucket_for(n)
        if bucket is None:
            raise ServingError(
                "prompt length %d exceeds largest prefill bucket %d"
                % (n, self.buckets[-1]), code="too_large")
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = np.asarray(token_ids, np.int64)
        last, k_new, v_new = self._prefill_for(bucket)(
            self.model.params, torch.from_numpy(toks).to(self.device),
            torch.tensor([n], dtype=torch.int64, device=self.device))
        return last[0], k_new, v_new

    def decode(self, k_slab, v_slab, lengths, tokens):
        """One step for every slot. ``lengths``/``tokens``: (slots,) ints
        (inactive slots: length 0, token 0). Updates the slabs in place
        and returns the logits (slots, V)."""
        return self._decode(
            self.model.params, k_slab, v_slab,
            torch.as_tensor(np.asarray(lengths, np.int64), device=self.device),
            torch.as_tensor(np.asarray(tokens, np.int64), device=self.device))

    def admit(self, k_slab, v_slab, k_new, v_new, slot: int):
        """Slot a prefilled sequence's K/V into the slabs (in place)."""
        self._admit(k_slab, v_slab, k_new, v_new, slot)
