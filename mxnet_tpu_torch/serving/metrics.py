"""Serving metrics surface.

Counterpart of ``mxnet_tpu/serving/metrics.py``. Follows metric.py's
EvalMetric idiom (``get()`` returns parallel name/value lists,
``get_name_value()`` zips them, ``reset()`` rezeroes) plus a batch-end
callback record in the ``callback.Speedometer`` style
(``ServingBatchEndParam``).

Tracked: QPS, p50/p95/p99 request latency, mean batch occupancy (real
rows per dispatched batch), padding efficiency (real rows / padded bucket
rows, the cost of fixed shapes), live queue depth, and a program cache's
compile / hit / miss counters. The process-wide
``serving_request_latency_ms`` histogram (:func:`latency_histogram`) is
what the decode scheduler feeds, one observation a finished stream.
"""
from __future__ import annotations

import threading
import time
from collections import deque, namedtuple
from typing import Callable, Dict, Optional, Sequence

from .. import telemetry

ServingBatchEndParam = namedtuple(
    "ServingBatchEndParam",
    ["nbatch", "bucket", "rows", "replica", "latency_ms", "occupancy",
     "metrics"])
"""Passed to the server's batch_end_callback after each dispatched batch:
batch ordinal, bucket size used, real rows, replica index, mean request
latency of the batch (ms), rows (== occupancy of this batch), and the live
ServingMetrics object."""


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


#: registry latency histogram buckets (ms) — coarse SLO bands; the
#: fine-grained percentiles stay on the ServingMetrics windows
LATENCY_BUCKETS_MS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)


def latency_histogram() -> "telemetry.Histogram":
    """The process-wide ``serving_request_latency_ms`` histogram. Unlike
    the windowed percentiles it is cumulative AND carries OpenMetrics
    exemplars: each bucket remembers the last ``trace_id`` observed into
    it, so a Prometheus latency bucket links to one concrete request
    timeline (``telemetry.flight.request_tree(trace_id)``)."""
    return telemetry.registry.histogram(
        "serving_request_latency_ms", buckets=LATENCY_BUCKETS_MS,
        help="end-to-end serving request latency (ms), predict + generate")


class ServingMetrics:
    """Thread-safe serving counters with metric.py-style getters."""

    #: ring-buffer size for latency percentiles (recent-window, not
    #: whole-lifetime, so a warmup spike ages out)
    LATENCY_WINDOW = 4096
    #: per-bucket ring-buffer size (smaller: there is one per bucket)
    BUCKET_LATENCY_WINDOW = 1024

    def __init__(self, queue_depth_fn: Optional[Callable[[], int]] = None,
                 cache_stats_fn: Optional[Callable[[], Dict]] = None,
                 router_inflight_fn: Optional[
                     Callable[[], Sequence[int]]] = None,
                 ladder_version_fn: Optional[Callable[[], int]] = None):
        self._lock = threading.Lock()
        self._queue_depth_fn = queue_depth_fn
        self._cache_stats_fn = cache_stats_fn
        # router gauges (set by InferenceServer): per-replica in-flight op
        # counts and the current bucket-ladder version — like the queue
        # depth gauge these are READ BEFORE _lock in get() (they reach into
        # engine/server state that must never nest inside _lock)
        self._router_inflight_fn = router_inflight_fn
        self._ladder_version_fn = ladder_version_fn
        self.reset()
        # the central registry adopts this instance (weakref'd), so
        # registry.exposition() carries every serving gauge as
        # serving_<name>{sid="..."}
        self.sid = telemetry.registry.register_group("serving", self)

    def reset(self):
        with self._lock:
            self._t0 = time.monotonic()
            self.n_submitted = 0
            self.n_completed = 0
            self.n_batches = 0
            self.sum_rows = 0
            self.sum_bucket_rows = 0
            self.errors: Dict[str, int] = {}
            self._lat: deque = deque(maxlen=self.LATENCY_WINDOW)
            # per-bucket latency windows + batch counts: the SLO seam —
            # tail latency is a property of a bucket (its compiled shape),
            # not of the mixed traffic aggregate
            self._bucket_lat: Dict[int, deque] = {}
            self._bucket_batches: Dict[int, int] = {}
            # request-size histogram (rows -> count): the BucketTuner's
            # input signal for adaptive ladder derivation
            self._size_hist: Dict[int, int] = {}

    # --- recorders (called by the server/batcher) -------------------------
    def record_submit(self, rows: int = 1):
        with self._lock:
            self.n_submitted += 1
            self._size_hist[rows] = self._size_hist.get(rows, 0) + 1

    def record_error(self, code: str):
        with self._lock:
            self.errors[code] = self.errors.get(code, 0) + 1

    def observe_latency(self, latency_ms: Optional[float],
                        trace_id: Optional[str] = None):
        """Feed one completed request into the registry latency
        histogram, attaching the request's trace id as the bucket's
        exemplar. Lock-free here — the histogram has its own leaf lock."""
        if latency_ms is not None:
            latency_histogram().observe(float(latency_ms),
                                        exemplar=trace_id)

    def record_batch(self, rows: int, bucket: int,
                     latencies_ms: Sequence[float]):
        with self._lock:
            self.n_batches += 1
            self.sum_rows += rows
            self.sum_bucket_rows += bucket
            self.n_completed += len(latencies_ms)
            self._lat.extend(latencies_ms)
            blat = self._bucket_lat.get(bucket)
            if blat is None:
                blat = self._bucket_lat[bucket] = deque(
                    maxlen=self.BUCKET_LATENCY_WINDOW)
            blat.extend(latencies_ms)
            self._bucket_batches[bucket] = \
                self._bucket_batches.get(bucket, 0) + 1

    # --- metric.py-style surface ------------------------------------------
    def get(self):
        """(names, values), EvalMetric.get() shape."""
        # read the gauges BEFORE taking _lock: depth() takes the former's
        # condition, and the former calls record_error (which takes _lock)
        # — nesting them here would order the locks ABBA; the router gauges
        # follow the same rule (they take engine._inflight_lock / read
        # server state)
        depth = self._queue_depth_fn() if self._queue_depth_fn else 0
        inflight = (list(self._router_inflight_fn())
                    if self._router_inflight_fn else [])
        ladder_version = (self._ladder_version_fn()
                          if self._ladder_version_fn else 0)
        with self._lock:
            dt = max(time.monotonic() - self._t0, 1e-9)
            lat = sorted(self._lat)
            names = ["qps", "latency_ms_p50", "latency_ms_p95",
                     "latency_ms_p99", "mean_batch_occupancy",
                     "padding_efficiency", "queue_depth", "requests",
                     "completed", "batches", "errors"]
            values = [
                self.n_completed / dt,
                _percentile(lat, 50), _percentile(lat, 95),
                _percentile(lat, 99),
                (self.sum_rows / self.n_batches) if self.n_batches
                else float("nan"),
                (self.sum_rows / self.sum_bucket_rows)
                if self.sum_bucket_rows else float("nan"),
                depth,
                self.n_submitted, self.n_completed, self.n_batches,
                sum(self.errors.values()),
            ]
            # padding_waste_pct: the complement of padding_efficiency in
            # percent — the headline the zero-copy/coalescing/tuning work
            # drives down (NaN until something dispatched)
            names.append("padding_waste_pct")
            values.append(
                100.0 * (1.0 - self.sum_rows / self.sum_bucket_rows)
                if self.sum_bucket_rows else float("nan"))
            names.append("bucket_ladder_version")
            values.append(ladder_version)
            for i, n in enumerate(inflight):
                names.append("router_inflight_replica%d" % i)
                values.append(n)
            # per-bucket gauges, stable order: bucket<k>_latency_ms_p50/
            # p95/p99 + bucket<k>_batches — the dashboard's SLO series
            for k in sorted(self._bucket_lat):
                blat = sorted(self._bucket_lat[k])
                for q in (50, 95, 99):
                    names.append("bucket%d_latency_ms_p%d" % (k, q))
                    values.append(_percentile(blat, q))
                names.append("bucket%d_batches" % k)
                values.append(self._bucket_batches.get(k, 0))
        if self._cache_stats_fn:
            stats = self._cache_stats_fn()
            for k in ("compile_cache_hits", "compile_cache_misses",
                      "compiles", "disk_hits"):
                names.append(k)
                values.append(stats.get(k.replace("compile_cache_", ""),
                                        stats.get(k, 0)))
        return names, values

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))

    def bucket_latency(self, bucket: int, q: float = 99.0) -> float:
        """The bucket's recent-window latency percentile (ms) — the SLO
        probe: alert when ``bucket_latency(k, 99) > budget_ms``. NaN until
        the bucket has dispatched."""
        with self._lock:
            blat = self._bucket_lat.get(bucket)
            return _percentile(sorted(blat), q) if blat else float("nan")

    def request_size_histogram(self) -> Dict[int, int]:
        """Copy of the rows -> submit-count histogram (the BucketTuner's
        input signal)."""
        with self._lock:
            return dict(self._size_hist)

    def error_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.errors)

    def __str__(self):
        return "ServingMetrics: %s" % dict(self.get_name_value())
