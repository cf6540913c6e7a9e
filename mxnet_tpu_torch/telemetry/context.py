"""Propagated trace context: W3C ``traceparent`` in, span trees out.

Counterpart of ``mxnet_tpu/telemetry/context.py``. Spans are per-thread
events; this module carries a request's identity across the threads its
work hops between (the submitting thread, the scheduler, the engine
worker):

- ``parse_traceparent()`` / ``to_traceparent()`` speak the W3C Trace
  Context wire format (``00-<32 hex trace>-<16 hex span>-<2 hex
  flags>``), so an upstream proxy's ids are honoured at an HTTP edge;
- ``mint()`` creates a fresh context when the caller sent none, and
  ``child()`` derives a per-stage context (new span_id, parent set to
  the creating span), so a request's events assemble into ONE tree;
- ``use()`` / ``current_context()`` is the thread-local carry. Serving
  stores the context ON the ``TokenStream``, so it survives the thread
  hops that ``threading.local`` alone cannot;
- ``mint_request_id()`` is the one request-id mint.

Cost: a context is three short strings; nothing here allocates per
*span*, only per request, and ``current_context()`` on a thread with no
context is a single ``getattr`` returning None.

Span ids are a process-salted counter, not ``os.urandom`` per span:
unique across processes (a 40-bit random salt) and far cheaper than a
system call per id.
"""
from __future__ import annotations

import itertools
import os
import threading
import uuid
from typing import Optional

_TRACEPARENT_HEADER = "traceparent"

# process-salted span-id mint: high 40 bits random (per-process), low
# bits a counter — collision-free within a process, fleet-unique with
# overwhelming probability across processes
_ids = itertools.count(int.from_bytes(os.urandom(5), "big") << 24)
_MASK64 = (1 << 64) - 1


def mint_span_id() -> str:
    return "%016x" % (next(_ids) & _MASK64)


def mint_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars, the W3C trace-id width


def mint_request_id() -> str:
    """The one request-id mint: 16 hex chars, stable enough to grep a
    fleet's logs."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One hop of a distributed trace: ``trace_id`` names the request's
    whole tree, ``span_id`` this hop, ``parent_id`` the hop that spawned
    it (None at the root). ``request_id`` rides along so operator-facing
    surfaces (error bodies, flight bundles) can key by either id."""

    __slots__ = ("trace_id", "span_id", "parent_id", "request_id",
                 "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None,
                 request_id: Optional[str] = None, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.request_id = request_id
        self.sampled = sampled

    def child(self) -> "TraceContext":
        """New span under this one (same trace, fresh span_id)."""
        return TraceContext(self.trace_id, mint_span_id(), self.span_id,
                            self.request_id, self.sampled)

    def stamps(self) -> dict:
        """The span-args dict every instrumented call site attaches —
        the keys the flight recorder and tree assembly key on."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.request_id:
            d["request_id"] = self.request_id
        return d

    def __repr__(self):
        return ("TraceContext(trace_id=%r, span_id=%r, parent_id=%r)"
                % (self.trace_id, self.span_id, self.parent_id))


def mint(request_id: Optional[str] = None) -> TraceContext:
    """Fresh root context (no inbound ``traceparent``)."""
    return TraceContext(mint_trace_id(), mint_span_id(),
                        request_id=request_id or mint_request_id())


def parse_traceparent(header: Optional[str],
                      request_id: Optional[str] = None
                      ) -> Optional[TraceContext]:
    """Parse a W3C ``traceparent`` header value. Returns None on any
    malformation (the spec says a broken header is *ignored*, not an
    error — the edge then mints a fresh context). The caller's span id
    becomes ``parent_id``; a fresh ``span_id`` is minted for our side."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, parent_span, flags = parts
    if (len(version) != 2 or len(trace_id) != 32 or len(parent_span) != 16
            or len(flags) != 2):
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(parent_span, 16)
        fl = int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or trace_id == "0" * 32 or parent_span == "0" * 16:
        return None
    return TraceContext(trace_id, mint_span_id(), parent_span,
                        request_id=request_id or mint_request_id(),
                        sampled=bool(fl & 0x01))


def to_traceparent(ctx: TraceContext) -> str:
    """Serialize for the wire (an HTTP response echo, a downstream call)."""
    return "00-%s-%s-%s" % (ctx.trace_id, ctx.span_id,
                            "01" if ctx.sampled else "00")


def from_headers(headers, request_id: Optional[str] = None) -> TraceContext:
    """HTTP-edge entry: honor an inbound ``traceparent`` (and
    ``x-request-id``) or mint fresh ids. ``headers`` is any mapping with
    ``.get`` (http.client's message object qualifies)."""
    rid = request_id or headers.get("x-request-id") or mint_request_id()
    ctx = parse_traceparent(headers.get(_TRACEPARENT_HEADER), rid)
    return ctx if ctx is not None else mint(rid)


# --- thread-local carry ------------------------------------------------------
_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    """The context installed on this thread, or None. This is the
    spans-off fast path for every propagation site: one getattr, no
    allocation. Not to be read inside a captured CUDA graph's body, which
    runs at the capture and never at a replay."""
    return getattr(_tls, "ctx", None)


class use:
    """``with context.use(ctx): ...`` installs ``ctx`` as the thread's
    current context for the block (None is allowed and means "clear").
    Re-entrant: the previous context is restored on exit, so an engine op
    re-installing a request's context nests under the worker's own."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def set_current(ctx: Optional[TraceContext]):
    _tls.ctx = ctx


def clear_current():
    _tls.ctx = None
