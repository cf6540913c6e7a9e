"""Bucketed executor cache: one bound forward per batch bucket.

Counterpart of ``mxnet_tpu/serving/bucket_cache.py``. The
BucketingModule discipline (N shapes, ONE shared parameter set) applied
to inference serving: requests are padded up to the nearest configured
batch bucket, so steady-state traffic touches only ``len(buckets)``
bound forwards and never binds again. Bucket executors are built lazily
by ``Predictor.reshape`` (the weights shared, the bind per bucket: on a
card a CUDA graph a bucket), and the base predictor is enrolled as its
own bucket, so a server over buckets (1, 4, 8) binds exactly three times.

The reference's persistent program cache (``progcache``: the model
fingerprint, per-bucket keys, the saved ladder and ``restore_ladder``) is
not ported; :meth:`BucketCache.restore_ladder` raises ``not_ported``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

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
        # a miss binds the bucket (the reference splits compiles from
        # program-cache disk loads; with no program cache every miss binds)
        self.compiles = 0
        self.disk_hits = 0
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
        return self._base.reshape(shapes, device=self._device)

    def _fetch_locked(self, bucket: int):
        """The executor for ``bucket``, binding it on a miss (caller holds
        ``_lock``)."""
        exe = self._execs.get(bucket)
        if exe is not None:
            self.hits += 1
        else:
            self.misses += 1
            exe = self._bind(bucket)
            self.compiles += 1
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
            self.compiles += 1
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
        return retired

    def restore_ladder(self, budget: Optional[int] = None) -> bool:
        """The reference adopts the ladder a previous process saved in its
        program cache; that cache is not ported."""
        raise ServingError("BucketCache.restore_ladder needs the persistent "
                           "program cache (progcache), which is not ported",
                           "not_ported")

    def warm(self):
        """Bind every bucket now (trade startup time for tail latency)."""
        for b in self.buckets:
            with self._lock:
                have = b in self._execs
            if not have:
                self.get(b)

    def stats(self) -> Dict[str, object]:
        """``compiles`` counts binds (every miss and every ``prepare``
        that enrolled); ``disk_hits`` stays 0 (no program cache);
        ``cache_hits`` is the in-memory hit count (alias of ``hits``)."""
        with self._lock:
            return {"hits": self.hits, "cache_hits": self.hits,
                    "misses": self.misses, "compiles": self.compiles,
                    "disk_hits": self.disk_hits,
                    "buckets": list(self.buckets),
                    "compiled": sorted(self._execs)}
