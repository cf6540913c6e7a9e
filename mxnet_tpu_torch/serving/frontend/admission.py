"""Admission control for the HTTP front-end.

Counterpart of ``mxnet_tpu/serving/frontend/admission.py``. Reject-early at the socket: a request that cannot be served — the
process is draining, the handler pool is saturated, or the batcher queue
is deep enough that batch-class work would only expire in the FIFO —
is answered immediately with 429/503 + ``Retry-After`` instead of being
queued into a timeout. This is the transport-level half of the policy;
the submit-time deadline-feasibility check lives in
``BatchFormer.submit`` (reject-early beats queue-and-expire).

Policies, in evaluation order:

1. draining (SIGTERM received)      -> 503 ``shutting_down``
2. in-flight >= ``max_inflight``    -> 503 ``overloaded``
   (``MXNET_HTTP_MAX_INFLIGHT`` — bounds handler threads + held results)
3. batch-class AND backlog >= ``shed_pct``% of the batcher's
   ``queue_depth``                  -> 429 ``shed``
   (``MXNET_HTTP_SHED_PCT`` — interactive traffic keeps the headroom
   between ``shed_pct`` and 100%, where ``queue_full`` takes over)

The shed signal counts the WHOLE pending pipeline, not just the former
deque: the former pipelines batches into the engine asynchronously
(``engine.push_async``), so under sustained overload the former drains
instantly and the backlog accumulates as outstanding engine ops on the
replica variables — ``former.depth()`` alone reads ~0 exactly when the
server is drowning. Backlog = queued requests + in-flight dispatched
batches (``server.router_inflight()``).

``Retry-After`` is estimated from that backlog times the recent
dispatch EWMA (minimum 1s) — an honest hint, not a promise.

Lock discipline: ``_lock`` is a LEAF — it guards only the in-flight
counter and draining flag; policy reads (``former.depth()``, which takes
the former's condition) happen strictly OUTSIDE the hold.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional, Tuple

from ... import telemetry
from ...telemetry import context as _trace_context
from ...telemetry import flight as _flight
from ..batcher import PRIORITY_BATCH


class AdmissionDecision:
    """A rejection: HTTP status + structured code + Retry-After hint."""

    __slots__ = ("status", "code", "message", "retry_after_s")

    def __init__(self, status: int, code: str, message: str,
                 retry_after_s: int):
        self.status = status
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Front-door gate shared by every handler thread."""

    def __init__(self, server, max_inflight: int, shed_pct: float):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if not 0.0 < float(shed_pct) <= 100.0:
            raise ValueError("shed_pct must be in (0, 100]")
        self._server = server
        self.max_inflight = int(max_inflight)
        self.shed_pct = float(shed_pct)
        self._lock = threading.Lock()
        self._inflight = 0
        self._draining = False
        reg = telemetry.registry
        self._m_requests = reg.counter(
            "http_requests_total", help="HTTP requests accepted past "
            "admission (all routes)")
        self._m_shed = reg.counter(
            "http_shed_total", help="HTTP requests rejected by admission "
            "control (429/503)")
        # the gauge is process-global (get-or-create) while controllers
        # are per-frontend: bind the callback through a weakref and
        # re-point the existing gauge at the newest live controller
        wref = weakref.ref(self)

        def _inflight_now():
            c = wref()
            return c.inflight() if c is not None else 0.0

        reg.gauge("http_inflight",
                  help="HTTP requests currently being handled")._fn = \
            _inflight_now

    # --- in-flight accounting (leaf lock) --------------------------------
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def enter(self):
        with self._lock:
            self._inflight += 1

    def exit(self):
        with self._lock:
            self._inflight -= 1

    # --- drain flag -------------------------------------------------------
    def set_draining(self):
        with self._lock:
            already = self._draining
            self._draining = True
        if not already:
            # drain start is an SLO anomaly worth a bundle: it captures
            # the in-flight picture a rolling restart interrupts
            _flight.on_anomaly("drain", inflight=self.inflight())

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    # --- the policy -------------------------------------------------------
    def _backlog(self) -> int:
        """Total pending work: requests queued in the former PLUS batches
        already dispatched but not yet completed (outstanding engine ops
        on the replica vars). The former hands batches to the engine
        asynchronously, so its own deque is near-empty under steady
        overload — the in-flight term is what actually measures
        saturation then. Servers without a router (unit-test stubs)
        contribute only the queued term."""
        former = self._server._former
        backlog = former.depth()
        inflight_fn = getattr(self._server, "router_inflight", None)
        if inflight_fn is not None:
            backlog += sum(inflight_fn())
        return backlog

    def _retry_after_s(self, backlog: Optional[int] = None) -> int:
        """Backlog-drain estimate: pending work x dispatch EWMA over
        the former's parallelism, floored at 1s."""
        former = self._server._former
        if backlog is None:
            backlog = self._backlog()
        eta = backlog * former.dispatch_ewma_s() \
            / max(1, former.parallelism)
        return max(1, int(eta + 0.999))

    def decide(self, priority: int) -> Tuple[Optional[AdmissionDecision],
                                             int]:
        """None = admitted (and counted in-flight — the caller MUST pair
        with ``exit()``); otherwise the rejection to send. Returns
        ``(decision, inflight_now)``."""
        with self._lock:
            if self._draining:
                decision = AdmissionDecision(
                    503, "shutting_down",
                    "server is draining for shutdown", 1)
                n = self._inflight
            elif self._inflight >= self.max_inflight:
                decision = AdmissionDecision(
                    503, "overloaded",
                    "%d requests in flight (MXNET_HTTP_MAX_INFLIGHT=%d)"
                    % (self._inflight, self.max_inflight), 0)
                n = self._inflight
            else:
                decision = None
                self._inflight += 1
                n = self._inflight
        if decision is None and priority == PRIORITY_BATCH:
            # backlog shed for the deferrable class, read OUTSIDE the
            # leaf lock (former.depth() takes the former's condition)
            backlog = self._backlog()
            cap = self._server._former.queue_depth
            if backlog >= self.shed_pct / 100.0 * cap:
                with self._lock:
                    self._inflight -= 1
                    n = self._inflight
                decision = AdmissionDecision(
                    429, "shed",
                    "batch-class shed: backlog %d/%d >= %g%% "
                    "(MXNET_HTTP_SHED_PCT)" % (backlog, cap, self.shed_pct),
                    self._retry_after_s(backlog))
        if decision is None:
            self._m_requests.inc()
        else:
            self._m_shed.inc()
            if decision.retry_after_s == 0:
                decision.retry_after_s = self._retry_after_s()
            if decision.code == "shed":
                # bundle the moment load shedding kicks in (bounded by
                # MXNET_FLIGHT_MAX_BUNDLES, so a sustained storm writes
                # a handful, not one per rejected request)
                _flight.on_anomaly(
                    "shed", _trace_context.current_context(),
                    message=decision.message,
                    retry_after_s=decision.retry_after_s)
        return decision, n
