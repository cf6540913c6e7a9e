"""Paged KV cache: block pool + per-sequence block tables + prefix reuse.

Counterpart of ``mxnet_tpu/serving/generate/paged.py``. The two slabs
become a pool of blocks of ``block_tokens`` KV positions each, and every
sequence owns a **block table**, a fixed-width ``(max_blocks,)`` int32
vector naming the physical block of each ``block_tokens``-position span
of its context. Admission is governed by the free-block count, so memory,
not the slot count, caps how many sequences run at once, and a short
sequence no longer reserves ``max_context`` positions.

Prefix reuse (``prefix_share``, default on): every admitted prompt
registers its token blocks under a chained content hash. A later prompt
whose leading blocks match **shares** those blocks (refcount + 1) instead
of prefilling them again: a shared system prompt is prefilled once. A
partly filled block can be shared too: the joiner's first divergent write
would land inside it, so its paged prefill **forks** it (copy on write)
into a block of the joiner's own reservation first. Sharers only ever
read shared blocks; every write goes to a private block.

No mid-stream eviction: admission reserves every block the sequence can
touch through ``min(prompt + max_new, capacity)``, so a running sequence
never allocates, and a waiting prompt is admitted when retirements free
blocks.

``_lock`` is a leaf lock over the tables, free list, refcounts and
prefix registry, never held across an engine push or a device call; the
slabs are serialized by the engine variable, as in ``KVCacheManager``.
"""
from __future__ import annotations

import hashlib
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import engine as _engine
from ..batcher import ServingError
from .kv_cache import AdmitPlan
from .programs import PagedDecodePrograms

#: physical block 0: inactive lanes and padded prefill positions write
#: into it, and it is never read unmasked
TRASH_BLOCK = 0


def _chain_hash(prev: str, tokens: Sequence[int]) -> str:
    """Content hash of one token block chained on its prefix's hash:
    equal chains <=> equal block-aligned token prefixes."""
    h = hashlib.sha1()
    h.update(prev.encode())
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


class PagedKVCacheManager:
    """Block allocator + paged slab holder for the decode state: the
    surface of ``KVCacheManager`` (``try_admit`` / ``free`` / ``advance``
    / ``length`` / ``truncate`` / ``owner`` / ``active_slots`` /
    ``occupancy_pct`` / ``step_arrays`` / ``reset`` / ``kv_bytes``) plus
    the pool's ``blocks_free`` / ``blocks_total``, the most blocks in use
    at once (``blocks_peak``) and the prefix counters."""

    def __init__(self, programs: PagedDecodePrograms,
                 prefix_share: bool = True):
        self.programs = programs
        self.slots = programs.slots
        self.capacity = programs.capacity
        self.block_tokens = programs.block_tokens
        self.max_blocks = programs.max_blocks
        self.num_blocks = programs.num_blocks
        self.prefix_share = bool(prefix_share)
        self.var = _engine.new_variable()
        _engine.track_inflight(self.var)
        self.k_slab, self.v_slab = programs.fresh_slabs()
        # int8 KV: per-position f32 scale slabs (L, NB + 1, T), forked and
        # scattered by the same callables that move the value blocks
        scales = programs.fresh_scale_slabs()
        self.k_scale, self.v_scale = scales if scales else (None, None)
        self._lock = threading.Lock()
        self._lengths = np.zeros(self.slots, np.int32)
        self._owner: List[Optional[object]] = [None] * self.slots
        self._free_slots: deque = deque(range(self.slots))
        # block pool: ids 1..num_blocks (0 = trash)
        self._free_blocks: deque = deque(range(1, self.num_blocks + 1))
        self._ref = np.zeros(self.num_blocks + 1, np.int32)
        self._tables = np.zeros((self.slots, self.max_blocks), np.int32)
        # each slot's admission reservation in blocks: truncate() keeps
        # the table entries inside it unless asked to release them
        self._reserved = np.zeros(self.slots, np.int32)
        # prefix registry: chained hash -> full block, chained hash ->
        # (block, partial token tuple); _block_keys maps a block to its
        # entries so a freed block leaves the registry
        self._full_index: Dict[str, int] = {}
        self._partial_index: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        self._block_keys: Dict[int, List[Tuple[str, str]]] = {}
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.cow_forks = 0
        self.blocks_peak = 0

    # --- admission (host-only, leaf lock) --------------------------------
    def try_admit(self, owner, prompt: Sequence[int],
                  max_new: int) -> Optional[AdmitPlan]:
        """Claim a slot and every block ``owner`` can ever write, sharing
        hash-matched prefix blocks; None if slots or blocks are short (the
        caller requeues: admission waits on retirement)."""
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        if n >= self.capacity:
            raise ServingError(
                "prompt length %d leaves no kv capacity (max_context %d)"
                % (n, self.capacity), code="too_large")
        T = self.block_tokens
        max_len = min(n + int(max_new), self.capacity)
        nb = -(-max_len // T)                  # blocks this stream can touch
        with self._lock:
            if not self._free_slots:
                return None
            # --- prefix match: full blocks, then one partial block ------
            shared: List[int] = []
            chain = "root"
            fork_src = TRASH_BLOCK
            p_part = 0
            if self.prefix_share:
                while (len(shared) + 1) * T <= n - 1:
                    h = _chain_hash(chain, prompt[len(shared) * T:
                                                  (len(shared) + 1) * T])
                    bid = self._full_index.get(h)
                    if bid is None:
                        break
                    shared.append(bid)
                    chain = h
                ent = self._partial_index.get(chain)
                if ent is not None:
                    bid, toks = ent
                    tail = prompt[len(shared) * T:]
                    # leave >= 1 token to prefill: the paged prefill is
                    # also how the stream gets its first logits
                    lim = min(len(toks), len(tail) - 1)
                    while p_part < lim and toks[p_part] == tail[p_part]:
                        p_part += 1
                    if p_part > 0:
                        fork_src = bid
            ctx_len = len(shared) * T + p_part
            first_new = len(shared)            # the boundary block's index
            need = nb - first_new
            if need > len(self._free_blocks):
                return None                    # wait for retirement
            slot = self._free_slots.popleft()
            table = np.zeros(self.max_blocks, np.int32)
            for idx, bid in enumerate(shared):
                table[idx] = bid
                self._ref[bid] += 1
            for k in range(need):
                bid = self._free_blocks.popleft()
                table[first_new + k] = bid
                self._ref[bid] = 1
            # the divergent write lands in the boundary block, which is
            # this stream's first private block: the fork's target
            fork_dst = int(table[first_new]) if p_part > 0 else TRASH_BLOCK
            self._register_prompt(prompt, table)
            self._owner[slot] = owner
            self._lengths[slot] = n
            self._tables[slot] = table
            self._reserved[slot] = nb
            if ctx_len > 0:
                self.prefix_hits += 1
                self.prefix_tokens_saved += ctx_len
            if fork_dst != TRASH_BLOCK:
                self.cow_forks += 1
            self.blocks_peak = max(self.blocks_peak,
                                   self.num_blocks - len(self._free_blocks))
        return AdmitPlan(slot=slot, suffix=prompt[ctx_len:], ctx_len=ctx_len,
                         table=table, fork_src=int(fork_src),
                         fork_dst=int(fork_dst))

    def _register_prompt(self, prompt: Sequence[int], table: np.ndarray):
        """Index this prompt's token blocks for later sharers (lock held).
        Only prompt tokens are registered: generated tokens land beyond
        the registered span, so an entry stays valid for its block's
        lifetime. The first registration wins."""
        if not self.prefix_share:
            return
        T = self.block_tokens
        n = len(prompt)
        chain = "root"
        j = 0
        while (j + 1) * T <= n:
            blk = tuple(int(t) for t in prompt[j * T:(j + 1) * T])
            prev = chain
            chain = _chain_hash(prev, blk)
            bid = int(table[j])
            if bid != TRASH_BLOCK:
                if chain not in self._full_index:
                    self._full_index[chain] = bid
                    self._block_keys.setdefault(bid, []).append(
                        ("full", chain))
                # a full block is also a partial entry, so a prompt that
                # is a proper prefix of it can share it (through a fork)
                if prev not in self._partial_index:
                    self._partial_index[prev] = (bid, blk)
                    self._block_keys.setdefault(bid, []).append(
                        ("partial", prev))
            j += 1
        rem = tuple(int(t) for t in prompt[j * T:])
        if rem:
            bid = int(table[j])
            if bid != TRASH_BLOCK and chain not in self._partial_index:
                self._partial_index[chain] = (bid, rem)
                self._block_keys.setdefault(bid, []).append(
                    ("partial", chain))

    def _release(self, bid: int):
        """Drop one reference to block ``bid`` (lock held); at zero it
        returns to the pool and leaves the prefix registry."""
        self._ref[bid] -= 1
        if self._ref[bid] <= 0:
            self._ref[bid] = 0
            self._free_blocks.append(bid)
            for kind, key in self._block_keys.pop(bid, []):
                index = (self._full_index if kind == "full"
                         else self._partial_index)
                index.pop(key, None)

    def free(self, slot: int):
        """Release a retired sequence's slot and its block references."""
        with self._lock:
            table = self._tables[slot]
            for bid in sorted({int(b) for b in table if b != TRASH_BLOCK}):
                self._release(bid)
            self._tables[slot] = 0
            self._owner[slot] = None
            self._lengths[slot] = 0
            self._reserved[slot] = 0
            self._free_slots.append(slot)

    # --- bookkeeping shared with the unpaged surface ----------------------
    def advance(self, slot: int) -> int:
        with self._lock:
            self._lengths[slot] += 1
            return int(self._lengths[slot])

    def length(self, slot: int) -> int:
        with self._lock:
            return int(self._lengths[slot])

    def truncate(self, slot: int, new_len: int, release: bool = False):
        """Rewind ``slot`` to ``new_len`` tokens, a block-table and length
        edit with no KV copies. Table entries wholly past the new length
        lose this slot's reference, as in ``free``; entries inside the
        admission reservation are kept (the sequence may grow back into
        them and must never allocate mid-stream) unless ``release``, which
        also shrinks the reservation. Idempotent."""
        T = self.block_tokens
        new_len = int(new_len)
        keep = -(-new_len // T)            # blocks still (partly) in use
        with self._lock:
            if self._owner[slot] is None:
                return
            self._lengths[slot] = new_len
            floor = keep if release \
                else max(keep, int(self._reserved[slot]))
            if release and keep < self._reserved[slot]:
                self._reserved[slot] = keep
            table = self._tables[slot]
            for idx in range(floor, self.max_blocks):
                bid = int(table[idx])
                if bid == TRASH_BLOCK:
                    continue
                table[idx] = TRASH_BLOCK
                self._release(bid)

    def owner(self, slot: int):
        with self._lock:
            return self._owner[slot]

    def active_slots(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.slots)
                    if self._owner[i] is not None]

    def occupancy_pct(self) -> float:
        with self._lock:
            used = sum(1 for o in self._owner if o is not None)
        return 100.0 * used / self.slots

    def blocks_total(self) -> int:
        return self.num_blocks

    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free_blocks)

    def step_arrays(self):
        """(lengths, tables) copies for the next decode step: inactive rows
        have length 0 and an all-trash table, so their lanes write block 0
        and read nothing unmasked."""
        with self._lock:
            return self._lengths.copy(), self._tables.copy()

    # --- slab plumbing ----------------------------------------------------
    def reset(self):
        """Fresh slabs + empty bookkeeping (recovery after a failed step).
        The captured decode graph worked on the old slabs: it is dropped,
        and the next step captures anew."""
        with self._lock:
            self._lengths[:] = 0
            self._owner = [None] * self.slots
            self._free_slots = deque(range(self.slots))
            self._free_blocks = deque(range(1, self.num_blocks + 1))
            self._ref[:] = 0
            self._tables[:] = 0
            self._reserved[:] = 0
            self._full_index.clear()
            self._partial_index.clear()
            self._block_keys.clear()
        self.programs.drop_capture()
        self.k_slab, self.v_slab = self.programs.fresh_slabs()
        scales = self.programs.fresh_scale_slabs()
        self.k_scale, self.v_scale = scales if scales else (None, None)

    def kv_bytes(self) -> int:
        return self.programs.kv_bytes()
