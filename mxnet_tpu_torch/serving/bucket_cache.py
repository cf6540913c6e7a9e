"""Bucketed executor cache: one bound forward per batch bucket.

Counterpart of ``mxnet_tpu/serving/bucket_cache.py``. The
BucketingModule discipline (N shapes, ONE shared parameter set) applied
to inference serving: requests are padded up to the nearest configured
batch bucket, so steady-state traffic touches only ``len(buckets)``
bound forwards and never binds again. Bucket executors are built lazily
by ``Predictor.reshape`` (the weights shared, the bind per bucket: on a
card a CUDA graph a bucket), and the base predictor is enrolled as its
own bucket, so a server over buckets (1, 4, 8) binds exactly three times.

With the persistent program cache on (``progcache``), each bucket's bind
is a disk load where a previous process stored that program (``stats()``
splits ``compiles`` from ``disk_hits``), every ladder swap saves the new
ladder under the model's fingerprint and bumps its entries' LRU clocks,
and :meth:`BucketCache.restore_ladder` adopts the ladder a previous
process saved: a restarted server lands on the tuned rungs and disk-loads
exactly their programs.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from .. import progcache as _progcache
from ..analysis import compile_witness as _witness
from .batcher import ServingError


class BucketCache:
    """Lazy per-bucket executor cache over a base ``predict.Predictor``.

    ``buckets`` are batch sizes along axis 0 of every input. The base
    predictor must be bound at per-example shapes consistent with the
    bucket shapes; if its batch size IS one of the buckets (the server
    binds it at the smallest), it is reused: enrollment is not a miss.
    """

    def __init__(self, base, buckets: Sequence[int], device=None):
        if not buckets:
            raise ServingError("at least one bucket batch size required")
        self.buckets: List[int] = sorted(set(int(b) for b in buckets))
        if self.buckets[0] < 1:
            raise ServingError("bucket batch sizes must be >= 1")
        self._base = base
        self._device = device
        self._lock = threading.Lock()
        self._execs: Dict[int, object] = {}
        self.hits = 0
        self.misses = 0
        # a miss binds the bucket: a build from the symbol (compiles) or,
        # with the program cache on, a disk load of its program
        self.compiles = 0
        self.disk_hits = 0
        self._witness_scope = _witness.new_scope()
        # LRU bookkeeping for ladder swaps: logical tick per get(), so
        # set_ladder can retire the executors traffic stopped touching
        self._tick = 0
        self._last_used: Dict[int, int] = {}
        base_batch = {s[0] for s in base._input_shapes.values()}
        if len(base_batch) == 1 and next(iter(base_batch)) in self.buckets:
            self._execs[next(iter(base_batch))] = base
        # per-example shapes (batch axis stripped) for reshape
        self._example_shapes = {n: tuple(s[1:])
                                for n, s in base._input_shapes.items()}

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def _too_large(self, rows: int) -> ServingError:
        return ServingError(
            "request of %d rows exceeds the largest bucket (%d); raise "
            "MXNET_SERVING_BUCKETS or split the request"
            % (rows, self.buckets[-1]), "error")

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket >= rows (the padding target)."""
        for b in self.buckets:
            if b >= rows:
                return b
        raise self._too_large(rows)

    def _bind(self, bucket: int):
        shapes = {n: (bucket,) + s for n, s in self._example_shapes.items()}
        with _witness.surface(self._witness_scope):
            return self._base.reshape(shapes, device=self._device)

    def _count_build(self, exe):
        if getattr(exe, "progcache_source", "compile") == "disk":
            self.disk_hits += 1
        else:
            self.compiles += 1

    def _fetch_locked(self, bucket: int):
        """The executor for ``bucket``, binding it on a miss (caller holds
        ``_lock``)."""
        exe = self._execs.get(bucket)
        if exe is not None:
            self.hits += 1
        else:
            self.misses += 1
            exe = self._bind(bucket)
            self._count_build(exe)
            self._execs[bucket] = exe
        self._last_used[bucket] = self._tick
        return exe

    def get(self, bucket: int):
        """The bound executor for ``bucket`` (binding on first use)."""
        with self._lock:
            self._tick += 1
            if bucket not in self._execs and bucket not in self.buckets:
                raise ServingError("%d is not a configured bucket (%s)"
                                   % (bucket, self.buckets))
            return self._fetch_locked(bucket)

    def acquire(self, rows: int):
        """``(bucket, executor)`` for ``rows`` against the CURRENT ladder,
        atomically with ``set_ladder``: a concurrent swap can never retire
        the chosen bucket between choosing and fetching it."""
        with self._lock:
            self._tick += 1
            bucket = next((b for b in self.buckets if b >= rows), None)
            if bucket is None:
                raise self._too_large(rows)
            return bucket, self._fetch_locked(bucket)

    def prepare(self, bucket: int):
        """Bind ahead for ``bucket`` without blocking the hot path: the
        reshape runs OUTSIDE ``_lock`` (it only reads the base) and the
        executor is enrolled under the lock afterwards, first writer wins.
        The bucket need not be in the current ladder: this is the warm-up
        half of a ladder swap (``set_ladder``)."""
        bucket = int(bucket)
        if bucket < 1:
            raise ServingError("bucket batch sizes must be >= 1")
        with self._lock:
            exe = self._execs.get(bucket)
            if exe is not None:
                return exe
        exe = self._bind(bucket)
        with self._lock:
            cur = self._execs.get(bucket)
            if cur is not None:
                return cur  # lost the race; the duplicate is dropped
            self._count_build(exe)
            self._execs[bucket] = exe
            self._last_used[bucket] = self._tick
            return exe

    def set_ladder(self, new_buckets: Sequence[int],
                   budget: Optional[int] = None) -> List[int]:
        """Swap the bucket ladder atomically; returns the retired buckets.

        The new ladder must keep ``max_batch`` (so every request the server
        admitted still finds a bucket). Executors of retired buckets are
        forgotten LRU-first; a dispatch already holding one is unaffected
        (its graph lives as long as that reference)."""
        nb = sorted(set(int(b) for b in new_buckets))
        if not nb:
            raise ServingError("at least one bucket batch size required")
        if nb[0] < 1:
            raise ServingError("bucket batch sizes must be >= 1")
        with self._lock:
            if nb[-1] != self.buckets[-1]:
                raise ServingError(
                    "ladder swap must preserve max_batch %d (got %s)"
                    % (self.buckets[-1], nb))
            self.buckets = nb
            keep = set(nb)
            retired = sorted((b for b in self._execs if b not in keep),
                             key=lambda b: self._last_used.get(b, -1))
            if budget is not None and len(keep & set(self._execs)) > budget:
                raise ServingError(
                    "ladder %s exceeds the program budget %d" % (nb, budget))
            for b in retired:
                del self._execs[b]
                self._last_used.pop(b, None)
        # outside _lock (progcache locks and writes files itself): save the
        # tuned ladder for a restarted server and bump the kept buckets'
        # LRU clocks, so the byte budget ages out the retired programs first
        self._progcache_sync(nb)
        return retired

    # --- persistent-cache integration ------------------------------------
    def _model_fp(self) -> Optional[str]:
        """The base predictor's model fingerprint (None with the program
        cache off or a base that cannot be hashed)."""
        if not _progcache.enabled():
            return None
        fp = getattr(self._base, "_progcache_model_fp", None)
        if fp is None:
            try:
                fp = _progcache.model_fingerprint(
                    self._base._symbol, self._base._arg_params,
                    self._base._aux_params)
                self._base._progcache_model_fp = fp
            except Exception:
                return None
        return fp

    def _bucket_key(self, fp: str, bucket: int) -> str:
        shapes = {n: (bucket,) + s for n, s in self._example_shapes.items()}
        device = (self._device if self._device is not None
                  else self._base._device)
        return _progcache.predictor_key(
            fp, list(shapes), shapes, self._base._dtype, device,
            extra=self._base._cache_extra())

    def _progcache_sync(self, buckets: List[int]):
        fp = self._model_fp()
        if fp is None:
            return
        _progcache.save_ladder(fp, buckets)
        for b in buckets:
            _progcache.touch(self._bucket_key(fp, b))

    def restore_ladder(self, budget: Optional[int] = None) -> bool:
        """Adopt the ladder a previous process saved for this model
        (``progcache.save_ladder``), so a warm restart starts at the tuned
        ladder and disk-loads exactly those programs. True when adopted;
        a saved ladder with another max_batch or over ``budget`` is
        ignored."""
        fp = self._model_fp()
        if fp is None:
            return False
        ladder = _progcache.load_ladder(fp)
        if not ladder or ladder == self.buckets:
            return False
        if ladder[-1] != self.max_batch:
            return False
        if budget is not None and len(ladder) > budget:
            return False
        self.set_ladder(ladder, budget)
        return True

    def warm(self):
        """Bind every bucket now (trade startup time for tail latency)."""
        for b in self.buckets:
            with self._lock:
                have = b in self._execs
            if not have:
                self.get(b)

    def stats(self) -> Dict[str, object]:
        """``compiles`` counts binds built from the symbol, ``disk_hits``
        binds loaded from the program cache (every miss and every
        ``prepare`` that enrolled is one or the other); ``cache_hits`` is
        the in-memory hit count (alias of ``hits``). With the compile
        witness armed the split comes from its record of this cache."""
        with self._lock:
            out = {"hits": self.hits, "cache_hits": self.hits,
                   "misses": self.misses, "compiles": self.compiles,
                   "disk_hits": self.disk_hits,
                   "buckets": list(self.buckets),
                   "compiled": sorted(self._execs)}
        if _witness.enabled():
            sc = _witness.scope_counts(self._witness_scope)
            out["compiles"] = sc["compiles"]
            out["disk_hits"] = sc["disk_hits"]
        return out
