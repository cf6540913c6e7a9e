"""Slot-allocated KV-cache slabs.

Counterpart of ``mxnet_tpu/serving/generate/kv_cache.py``.
``KVCacheManager`` owns the decode state the engine serializes: the two
``(L, slots, Hkv, C, Dh)`` slabs live behind ONE engine variable, and
every program that touches them (admit, step, both in place) is pushed
with ``mutable_vars=[var]``, so the engine orders step N+1 after step N
and after any admits between them. The reference keeps one manager per
replica; the port serves one replica until ``InferenceServer`` comes.

The host-side bookkeeping (which slot belongs to which sequence, each
row's length) is guarded by ``_lock``, a leaf lock never held across an
engine push or device call.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import List, Optional

import numpy as np

from ... import engine as _engine
from ..batcher import ServingError
from .programs import DecodePrograms


@dataclasses.dataclass
class AdmitPlan:
    """What the scheduler needs to turn one queued prompt into one
    admission op: the slot and the tokens the prefill program must run
    (the whole prompt; the reference's paged fields come with paged KV)."""
    slot: int
    suffix: List[int]


class KVCacheManager:
    """Slot allocator + slab holder for the decode state."""

    def __init__(self, programs: DecodePrograms):
        self.programs = programs
        self.slots = programs.slots
        self.capacity = programs.capacity
        self.var = _engine.new_variable()
        _engine.track_inflight(self.var)
        self.k_slab, self.v_slab = programs.fresh_slabs()
        self._lock = threading.Lock()
        # lengths[i] = tokens materialized in row i's kv (prompt +
        # generated so far); owner[i] = opaque sequence tag
        self._lengths = np.zeros(self.slots, np.int64)
        self._owner: List[Optional[object]] = [None] * self.slots
        self._free_slots: deque = deque(range(self.slots))

    # --- slot bookkeeping (host-only, leaf lock) -------------------------
    def alloc(self, owner, prompt_len: int) -> Optional[int]:
        """Claim a free slot for ``owner``; None if the batch is full."""
        if prompt_len > self.capacity:
            raise ServingError(
                "prompt length %d exceeds kv capacity %d"
                % (prompt_len, self.capacity), code="too_large")
        with self._lock:
            if not self._free_slots:
                return None
            slot = self._free_slots.popleft()
            self._owner[slot] = owner
            self._lengths[slot] = prompt_len
            return slot

    def try_admit(self, owner, prompt, max_new: int) -> Optional[AdmitPlan]:
        """Admission in plan form: a slot is the whole reservation and the
        suffix is the whole prompt (``max_new`` is unused — every slot owns
        a full-capacity lane)."""
        slot = self.alloc(owner, len(prompt))
        if slot is None:
            return None
        return AdmitPlan(slot=slot, suffix=[int(t) for t in prompt])

    def free(self, slot: int):
        with self._lock:
            if self._owner[slot] is None:
                return                      # idempotent double-free guard
            self._owner[slot] = None
            self._lengths[slot] = 0
            self._free_slots.append(slot)

    def advance(self, slot: int) -> int:
        """Record one decoded token in ``slot``; returns the new length."""
        with self._lock:
            self._lengths[slot] += 1
            return int(self._lengths[slot])

    def length(self, slot: int) -> int:
        with self._lock:
            return int(self._lengths[slot])

    # --- slab plumbing ----------------------------------------------------
    def reset(self):
        """Fresh slabs + empty bookkeeping."""
        with self._lock:
            self._lengths[:] = 0
            self._owner = [None] * self.slots
            self._free_slots = deque(range(self.slots))
        self.k_slab, self.v_slab = self.programs.fresh_slabs()

    def kv_bytes(self) -> int:
        return self.programs.kv_bytes()
