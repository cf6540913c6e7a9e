"""Adaptive bucket-ladder derivation from the observed request-size mix.

Counterpart of ``mxnet_tpu/serving/tuner.py`` (host-only, the same
math). The static ladder (``MXNET_SERVING_BUCKETS``) encodes a guess about
the request-size distribution; ``BucketTuner`` replaces the guess with the
measured histogram (``ServingMetrics.request_size_histogram()``). Each
bucket is one bound program (a CUDA graph a bucket and replica on a
card), so serving wants FEW of them (the ``program_budget``) whose shapes
sit just above the probability mass of the size mix: every row between a
request and its bucket is padded compute.

``derive()`` solves that placement exactly: at most ``program_budget``
bucket boundaries from the observed sizes (the largest pinned at
``max_batch`` so the ladder covers every admissible request) minimizing
total padded rows, by dynamic programming over the sorted candidate
sizes, O(S^2 * K) for S distinct sizes and budget K, run off the hot
path on an engine op.

The tuner carries no lock: retunes are serialized by the server's tuner
engine variable, and ``derive`` is a pure function of its arguments.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .batcher import ServingError


def padded_rows(ladder: Sequence[int], size_hist: Dict[int, int]) -> int:
    """Total rows dispatched (real + padding) serving ``size_hist`` on
    ``ladder``: each size pays the smallest bucket >= it. Sizes above the
    ladder are ignored (they could never have been admitted)."""
    buckets = sorted(ladder)
    total = 0
    for size, count in size_hist.items():
        for b in buckets:
            if b >= size:
                total += b * count
                break
    return total


class BucketTuner:
    """Derives the padding-optimal bucket ladder under a program budget.

    Invariants every derived ladder satisfies (property-tested):

    - ``max_batch`` is always a member, so any request the server admitted
      (rows <= max_batch) still finds a bucket after a swap — a retune can
      never strand an in-flight request;
    - at most ``program_budget`` buckets (== compiled programs per
      replica);
    - strictly increasing, all within ``[1, max_batch]``.
    """

    def __init__(self, max_batch: int, program_budget: int,
                 min_samples: int = 64, min_improvement_pct: float = 1.0):
        if max_batch < 1:
            raise ServingError("max_batch must be >= 1")
        if program_budget < 1:
            raise ServingError("program_budget must be >= 1")
        self.max_batch = int(max_batch)
        self.program_budget = int(program_budget)
        self.min_samples = int(min_samples)
        self.min_improvement_pct = float(min_improvement_pct)

    # --- pure ladder math -------------------------------------------------
    def derive(self, size_hist: Dict[int, int]) -> List[int]:
        """The optimal ladder for ``size_hist``: minimizes total padded
        rows over ladders of <= program_budget buckets that include
        ``max_batch``. An empty histogram yields ``[max_batch]``."""
        hist = {min(int(s), self.max_batch): 0 for s in size_hist if s >= 1}
        for s, c in size_hist.items():
            if s >= 1 and c > 0:
                hist[min(int(s), self.max_batch)] += int(c)
        hist = {s: c for s, c in hist.items() if c > 0}
        if not hist:
            return [self.max_batch]
        # candidate boundaries: the observed sizes plus the pinned top;
        # an optimal ladder only ever places boundaries AT observed sizes
        # (lowering a boundary to the largest size it serves never adds
        # padding), so this candidate set loses nothing.
        vals = sorted(set(hist) | {self.max_batch})
        n = len(vals)
        budget = min(self.program_budget, n)
        # seg_cost[i][j]: padding-inclusive rows for sizes in
        # (vals[i-1], vals[j]] all served by a bucket at vals[j]
        counts = [hist.get(v, 0) for v in vals]
        seg_cost = [[0] * n for _ in range(n + 1)]
        for j in range(n):
            rows = 0
            for i in range(j, -1, -1):
                rows += counts[i] * vals[j]
                seg_cost[i][j] = rows
        INF = float("inf")
        # dp[k][j]: min rows covering sizes <= vals[j] with k buckets, the
        # last at vals[j]
        dp = [[INF] * n for _ in range(budget + 1)]
        parent: List[List[Optional[Tuple[int, int]]]] = \
            [[None] * n for _ in range(budget + 1)]
        for j in range(n):
            dp[1][j] = seg_cost[0][j]
        for k in range(2, budget + 1):
            for j in range(k - 1, n):
                for i in range(k - 2, j):
                    c = dp[k - 1][i] + seg_cost[i + 1][j]
                    if c < dp[k][j]:
                        dp[k][j] = c
                        parent[k][j] = (k - 1, i)
        last = n - 1  # the ladder must end at max_batch (vals[-1])
        best_k = min(range(1, budget + 1), key=lambda k: dp[k][last])
        ladder = [vals[last]]
        k, j = best_k, last
        while parent[k][j] is not None:
            k, j = parent[k][j]
            ladder.append(vals[j])
        return sorted(ladder)

    # --- swap policy ------------------------------------------------------
    def propose(self, size_hist: Dict[int, int],
                current: Sequence[int]) -> Optional[List[int]]:
        """The ladder the server should swap to, or None to keep
        ``current``: requires ``min_samples`` observations and a relative
        padded-rows improvement of at least ``min_improvement_pct`` (the
        hysteresis that stops a noisy mix from flapping the compile
        cache)."""
        n = sum(c for s, c in size_hist.items() if 1 <= s)
        if n < self.min_samples:
            return None
        ladder = self.derive(size_hist)
        if list(ladder) == sorted(current):
            return None
        now = padded_rows(current, size_hist)
        then = padded_rows(ladder, size_hist)
        if now <= 0:
            return None
        if 100.0 * (now - then) / now < self.min_improvement_pct:
            return None
        return ladder
