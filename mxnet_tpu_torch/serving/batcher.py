"""Request queue + micro-batch former for the serving subsystem.

Counterpart of ``mxnet_tpu/serving/batcher.py``. Throughput comes from
coalescing concurrent requests into a few fixed shapes and keeping the
device fed. ``BatchFormer`` is the coalescing stage: a bounded FIFO with
per-request deadlines and a max-batch-size / max-queue-delay window
(dispatch as soon as ``max_batch`` rows are queued OR the oldest request
has waited ``max_delay_ms``, whichever first).

Failure is structured: every way a request can fail carries a
``ServingError`` with a machine-readable ``code``:

- ``queue_full``         the bounded queue rejected the submit
- ``too_large``          the request can never be served (its rows exceed
                         ``max_batch``, or a prompt is too long)
- ``deadline_exceeded``  the request expired (or could not make its
                         deadline at submit, given the queue)
- ``shutdown``           the server stopped while the request was queued
- ``shutting_down``      the server is draining; new submits are refused
- ``dispatch_error``     a device program raised; the request carries it
- ``wait_timeout``       a caller's wait gave up
- ``cancelled``          the caller cancelled an in-flight generate stream
- ``not_ported``         the option exists in the reference but not here yet
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..base import MXNetError
from .. import telemetry
from ..telemetry import flight as _flight


class ServingError(MXNetError):
    """Structured serving failure; ``code`` is machine-readable (see module
    docstring for the vocabulary)."""

    def __init__(self, msg: str, code: str = "error"):
        super().__init__(msg)
        self.code = code


#: priority/QoS classes, in admission order: interactive requests are
#: always dispatched before batch-class requests queued at the same time
#: (FIFO within a class — a class never reorders internally)
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1
_N_PRIORITIES = 2


class Request:
    """One in-flight request: a dict of name -> np.ndarray with a leading
    batch axis (usually 1 row; small batches ride whole — the former never
    splits a request across micro-batches). ``priority`` is the QoS class
    (``PRIORITY_INTERACTIVE``/``PRIORITY_BATCH``); ``request_id`` is an
    opaque caller correlation id echoed by the HTTP front-end;
    ``trace`` is the request's propagated ``telemetry.TraceContext``
    (or None) — the object carry that survives the HTTP-thread →
    former-thread → engine-worker hops."""

    __slots__ = ("inputs", "rows", "deadline", "submitted", "latency_ms",
                 "priority", "request_id", "trace", "_event", "_outputs",
                 "_error")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline: Optional[float], priority: int = 0,
                 request_id: Optional[str] = None, trace=None):
        self.inputs = inputs
        self.rows = rows
        self.deadline = deadline          # time.monotonic() absolute, or None
        self.trace = trace
        if not 0 <= int(priority) < _N_PRIORITIES:
            raise ServingError("priority must be 0 (interactive) or 1 "
                               "(batch), got %r" % (priority,))
        self.priority = int(priority)
        self.request_id = request_id
        self.submitted = time.monotonic()
        self.latency_ms: Optional[float] = None
        self._event = threading.Event()
        self._outputs: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    def set_result(self, outputs: List[np.ndarray]):
        self.latency_ms = (time.monotonic() - self.submitted) * 1e3
        self._outputs = outputs
        self._event.set()

    def set_error(self, err: BaseException):
        self.latency_ms = (time.monotonic() - self.submitted) * 1e3
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block for the result (``timeout`` in seconds). Raises the
        request's ServingError on failure."""
        if not self._event.wait(timeout):
            raise ServingError("result not ready after %.3fs" % timeout,
                               "wait_timeout")
        if self._error is not None:
            raise self._error
        return self._outputs


class BatchFormer:
    """Bounded request queue + micro-batch former.

    ``submit`` is the backpressure point: a full queue rejects immediately
    (the caller sheds load or retries) rather than buffering unboundedly,
    and a request whose deadline is already infeasible — given queued rows
    and the recent dispatch-latency EWMA fed by ``note_dispatch`` — is
    rejected at submit time with ``deadline_exceeded`` instead of being
    queued only to expire in the FIFO (reject-early beats queue-and-expire
    under overload: the client learns NOW, and the queue carries only work
    that can still meet its deadline).
    ``next_batch`` is the worker side: blocks for traffic, then holds the
    window open up to ``max_delay_ms`` past the OLDEST queued request's
    arrival while rows accumulate toward ``max_batch``. Expired requests
    are failed (``deadline_exceeded``) at pop time and do not poison the
    batch — the queue keeps draining.

    Priority/QoS: two admission classes (``Request.priority`` —
    interactive 0, batch 1). The former packs interactive requests first;
    batch-class requests ride only in the remaining row budget. Each class
    keeps FIFO order internally, and the delay window still opens from the
    oldest queued request regardless of class, so batch work is deferred
    under load but never starved while the queue drains.
    """

    def __init__(self, max_batch: int, max_delay_ms: float = 2.0,
                 queue_depth: int = 256, error_hook=None,
                 buckets_fn=None, coalesce_fill: float = 0.0):
        if max_batch < 1 or queue_depth < 1:
            raise ServingError("max_batch and queue_depth must be >= 1")
        if not 0.0 <= float(coalesce_fill) <= 1.0:
            raise ServingError("coalesce_fill must be in [0, 1]")
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self._error_hook = error_hook  # called with the code of each failure
        # cross-bucket coalescing: pack toward the LARGEST ladder bucket
        # that the queued rows fill to >= coalesce_fill, instead of packing
        # max_batch rows and letting dispatch pad to whatever bucket the
        # total lands in. buckets_fn returns the live ladder (it changes
        # under adaptive tuning); coalesce_fill == 0 disables the policy.
        self._buckets_fn = buckets_fn
        self.coalesce_fill = float(coalesce_fill)
        # one FIFO per priority class; all guarded by _cond
        self._qs = tuple(deque() for _ in range(_N_PRIORITIES))
        self._rows = 0  # queued rows (cached sum over self._qs)
        self._cond = threading.Condition()
        self._closed = False
        self._close_code = "shutdown"  # what post-close submits raise
        # reject-early feasibility estimate: EWMA of recent dispatch
        # service time (seconds per micro-batch), fed by note_dispatch
        # from the server's dispatch tail; parallelism = replica count
        # (concurrent dispatches divide the backlog drain time)
        self._ewma_batch_s = 0.0
        self._ewma_n = 0
        self.parallelism = 1

    def _fail(self, req: Request, err: ServingError):
        req.set_error(err)
        if self._error_hook is not None:
            self._error_hook(err.code)
        # observability tail (callers invoke _fail OUTSIDE _cond): a
        # failed request still gets a serving.queued span so its flight
        # timeline is complete, and a missed deadline snapshots a
        # diagnostic bundle — the SLO anomaly this queue exists to avoid
        if req.trace is not None and telemetry.enabled("serving"):
            telemetry.complete("serving.queued", domain="serving",
                               start_ns=int(req.submitted * 1e9),
                               rows=req.rows, error=err.code,
                               **req.trace.child().stamps())
        _flight.request_end(req.trace, ok=False, code=err.code,
                            latency_ms=req.latency_ms,
                            request_id=req.request_id)
        if err.code == "deadline_exceeded":
            _flight.on_anomaly("deadline_miss", req.trace,
                               request_id=req.request_id,
                               latency_ms=req.latency_ms,
                               message=str(err))

    def note_dispatch(self, seconds: float):
        """Feed one observed dispatch service time (seconds from batch
        handoff to results published) into the reject-early EWMA. Called
        by the server's dispatch tail from an engine worker — a leaf-style
        touch of ``_cond`` with nothing else held."""
        if seconds < 0:
            return
        with self._cond:
            if self._ewma_n == 0:
                self._ewma_batch_s = float(seconds)
            else:
                self._ewma_batch_s += 0.2 * (float(seconds)
                                             - self._ewma_batch_s)
            self._ewma_n += 1

    def dispatch_ewma_s(self) -> float:
        """Recent dispatch service-time estimate (0.0 until warmed)."""
        with self._cond:
            return self._ewma_batch_s if self._ewma_n else 0.0

    def _eta_s_locked(self, rows: int) -> Optional[float]:
        """Estimated seconds until a request of ``rows`` submitted NOW
        would finish dispatching, or None when the EWMA isn't warm yet
        (< 3 samples — never reject on a cold estimate). Caller holds
        ``_cond``."""
        if self._ewma_n < 3:
            return None
        backlog = self._rows + rows
        batches = -(-backlog // self.max_batch)  # ceil
        return batches * self._ewma_batch_s / max(1, self.parallelism)

    def submit(self, req: Request):
        if req.rows > self.max_batch:
            raise ServingError(
                "request of %d rows exceeds max_batch (%d); split it or "
                "raise the largest bucket" % (req.rows, self.max_batch),
                "too_large")
        now = time.monotonic()
        with self._cond:
            if self._closed:
                raise ServingError(
                    "server is shut down" if self._close_code == "shutdown"
                    else "server is draining for shutdown",
                    self._close_code)
            depth = sum(len(q) for q in self._qs)
            if depth >= self.queue_depth:
                raise ServingError(
                    "queue full (%d requests; MXNET_SERVING_QUEUE_DEPTH)"
                    % depth, "queue_full")
            if req.deadline is not None:
                # reject-early: never enqueue work that cannot make its
                # deadline given the queued-rows backlog and the recent
                # dispatch EWMA. Gated on a WARM estimate (>= 3 samples):
                # a cold former keeps the historical pop-time expiry path
                # so the contract is unchanged until real latencies exist.
                eta = self._eta_s_locked(req.rows)
                if eta is not None and now + eta >= req.deadline:
                    raise ServingError(
                        "deadline infeasible at submit: ~%.1f ms of queued "
                        "work ahead, %.1f ms budget left"
                        % (eta * 1e3, (req.deadline - now) * 1e3),
                        "deadline_exceeded")
            self._qs[req.priority].append(req)
            self._rows += req.rows
            self._cond.notify()

    def depth(self) -> int:
        """Queued (not yet dispatched) request count — the live gauge."""
        with self._cond:
            return sum(len(q) for q in self._qs)

    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self, code: str = "shutdown"):
        """Stop admitting; wake the former loop so it can drain and exit.
        ``code`` is what later submits raise (``"shutting_down"`` during
        a graceful drain, ``"shutdown"`` once stopped)."""
        with self._cond:
            self._closed = True
            self._close_code = code
            self._cond.notify_all()

    def fail_pending(self, code: str = "shutdown",
                     msg: str = "server stopped with the request queued"):
        """Fail every queued request (post-close, non-draining stop)."""
        with self._cond:
            pending = [r for q in self._qs for r in q]
            for q in self._qs:
                q.clear()
            self._rows = 0
        for r in pending:
            self._fail(r, ServingError(msg, code))

    def _pack_target(self, ladder) -> int:
        """Row target for the batch about to be packed (caller holds
        ``_cond``; ``ladder`` was snapshotted BEFORE the lock — the
        buckets callback reaches into server state and must not run
        under ``_cond``: the two would nest ABBA). Plain forming packs
        toward max_batch; with coalescing on, pick the largest ladder
        bucket the queued rows fill to >= ``coalesce_fill`` — e.g. 5
        queued single rows on ladder (1, 4, 8) at fill 1.0 dispatch as
        a FULL bucket-4 batch plus a bucket-1 batch, instead of one
        5-row batch padded to 8. When no bucket meets the fill bar the
        window has already expired, so everything queued goes now
        (max_batch) and dispatch pads as before."""
        if not ladder or self.coalesce_fill <= 0:
            return self.max_batch
        eligible = [b for b in ladder
                    if self._rows >= self.coalesce_fill * b]
        return max(eligible) if eligible else self.max_batch

    def next_batch(self) -> Optional[List[Request]]:
        """Form the next micro-batch (>= 1 request, <= max_batch rows).
        Returns None when closed and fully drained."""
        while True:
            expired: List[Request] = []
            # ladder snapshot for coalescing, read OUTSIDE _cond: the
            # callback reads server state and a stale-by-one-swap ladder
            # only changes the advisory pack target
            ladder = self._buckets_fn() if (
                self._buckets_fn is not None and self.coalesce_fill > 0
            ) else None
            with self._cond:
                while not any(self._qs) and not self._closed:
                    self._cond.wait()
                if not any(self._qs) and self._closed:
                    return None
                # hold the window open from the OLDEST head request's
                # arrival regardless of class (a queued batch-class request
                # still bounds its wait); closed => dispatch immediately
                t_end = min(q[0].submitted for q in self._qs if q) \
                    + self.max_delay
                while (self._rows < self.max_batch and not self._closed):
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                target = self._pack_target(ladder)
                batch, rows, now, full = [], 0, time.monotonic(), False
                # admission order: interactive class drains first; batch
                # class rides in the leftover row budget (FIFO per class).
                # The first non-fitting head stops packing entirely — a
                # lower class must not slip past it into this micro-batch
                # (priority inversion); the next micro-batch takes it.
                for q in self._qs:
                    while q and not full:
                        req = q[0]
                        if req.expired(now):
                            q.popleft()
                            self._rows -= req.rows
                            expired.append(req)
                            continue
                        if rows + req.rows > target and batch:
                            full = True
                            break  # next micro-batch takes it
                        q.popleft()
                        self._rows -= req.rows
                        batch.append(req)
                        rows += req.rows
                    if full:
                        break
            # fail outside _cond: the error hook may take other locks
            # (e.g. ServingMetrics._lock, whose holder may call depth())
            for req in expired:
                self._fail(req, ServingError(
                    "deadline exceeded after %.1f ms in queue"
                    % ((now - req.submitted) * 1e3), "deadline_exceeded"))
            if batch:
                return batch
            # every popped request had expired: go back to waiting
