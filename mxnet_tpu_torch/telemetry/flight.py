"""SLO flight recorder: a bounded ring of recent request timelines and
anomaly-triggered diagnostic bundles.

Counterpart of ``mxnet_tpu/telemetry/flight.py``. As a flight data
recorder keeps the last minutes, the interesting window is on disk when
something goes wrong. Two stores:

- a **live** table of per-trace spans, fed by a tracer tee: every span
  whose args carry ``trace_id`` (stamped by
  ``context.TraceContext.stamps()``) is copied here as it completes, from
  whatever thread recorded it. Batch-level spans (``serving.dispatch`` /
  ``decode.step``) carry ``trace_ids``, a list, and fan out to every
  member trace, so a request's tree holds the batches it rode;
- a **ring** of completed request timelines (``MXNET_FLIGHT_RING``,
  default 256): when serving reports a request finished
  (``request_end``), its live spans move into one immutable record.

Anomaly triggers (a deadline miss, and the ``MXNET_SLOW_REQUEST_MS``
threshold) call :func:`on_anomaly`, which writes a diagnostic bundle
(the victim's span tree, the recent ring, the full metrics exposition
and the ``MXNET_*`` settings) to ``MXNET_FLIGHT_DIR`` and bumps
``flight_bundles_total{trigger=}``. Bundle files are pid-tagged; at most
``MXNET_FLIGHT_MAX_BUNDLES`` (default 16) are written per process; past
that the trigger still counts (``flight_bundles_dropped_total``) but the
disk stays bounded.

The recorder is ON by default (``MXNET_FLIGHT_RECORDER=0`` disables it;
``MXNET_TELEMETRY=0`` kills it with the rest of telemetry). With spans
off it still records request completions and triggers: the ring then
holds ids, latency and outcome without span trees. Per-span cost exists
only when spans are on AND the span was trace-stamped.

Locking: one leaf lock, never taken while holding a serving or engine
lock, and no user code runs under it. Metric bumps and file writes
happen outside it.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from . import tracer
from .metrics import registry
from .context import TraceContext

#: per-trace span cap — a runaway stream cannot grow one timeline
#: unbounded (oldest kept: the edge and root spans matter most)
_MAX_SPANS_PER_TRACE = 256
#: live-table trace cap (LRU eviction) — traces that never report
#: completion (crashed client, lost stream) age out
_MAX_LIVE_TRACES = 1024

_enabled = (os.environ.get("MXNET_FLIGHT_RECORDER", "1") != "0"
            and os.environ.get("MXNET_TELEMETRY", "1") != "0")

_lock = threading.Lock()
_live: "OrderedDict[str, List[dict]]" = OrderedDict()
_ring: deque = deque(
    maxlen=max(1, int(os.environ.get("MXNET_FLIGHT_RING", "256"))))
_bundles_written: List[str] = []
_triggers: deque = deque(maxlen=64)
_seq = 0


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> bool:
    """Flip the recorder (tests / embedders); returns the prior state."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def _dir() -> str:
    return os.environ.get("MXNET_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "mxnet_tpu_torch_flight")


def _slow_ms() -> float:
    try:
        return float(os.environ.get("MXNET_SLOW_REQUEST_MS", "0") or 0)
    except ValueError:
        return 0.0


def _max_bundles() -> int:
    return int(os.environ.get("MXNET_FLIGHT_MAX_BUNDLES", "16"))


# --- tracer tee --------------------------------------------------------------
def _sink(ph: str, name: str, domain: str, ts_ns: int, dur_ns: int,
          args: Optional[dict]):
    """Installed as the tracer's span sink: called (from the recording
    thread) for every completed span whose args are trace-stamped."""
    if not _enabled or not args:
        return
    span = {"ph": ph, "name": name, "domain": domain, "ts_ns": ts_ns,
            "dur_ns": dur_ns, "args": dict(args),
            "tid": threading.get_ident()}
    tids = args.get("trace_ids")
    one = args.get("trace_id")
    targets = list(tids) if tids else []
    if one:
        targets.append(one)
    with _lock:
        for t in targets:
            lst = _live.get(t)
            if lst is None:
                while len(_live) >= _MAX_LIVE_TRACES:
                    _live.popitem(last=False)
                lst = _live[t] = []
            if len(lst) < _MAX_SPANS_PER_TRACE:
                lst.append(span)


tracer.set_span_sink(_sink)


# --- request lifecycle -------------------------------------------------------
def request_end(trace: Optional[TraceContext], ok: bool,
                code: Optional[str] = None,
                latency_ms: Optional[float] = None,
                kind: str = "predict", request_id: Optional[str] = None):
    """Serving reports one request finished (success OR failure). Moves
    the trace's live spans into the completed ring and fires the
    slow-request trigger when the ``MXNET_SLOW_REQUEST_MS`` threshold
    is set and exceeded. Spans-off cost: one lock + deque append."""
    if not _enabled:
        return
    tid = trace.trace_id if trace is not None else None
    rid = request_id or (trace.request_id if trace is not None else None)
    rec = {"request_id": rid, "trace_id": tid, "ok": bool(ok),
           "code": code, "latency_ms": latency_ms, "kind": kind,
           "ts": time.time()}
    with _lock:
        rec["spans"] = _live.pop(tid, []) if tid else []
        _ring.append(rec)
    slow = _slow_ms()
    if ok and slow > 0 and latency_ms is not None and latency_ms > slow:
        on_anomaly("slow_request", trace, request_id=rid,
                   latency_ms=latency_ms, threshold_ms=slow)


# --- anomaly triggers --------------------------------------------------------
def on_anomaly(trigger: str, trace: Optional[TraceContext] = None,
               **detail) -> Optional[str]:
    """An SLO anomaly happened: write one diagnostic bundle to
    ``MXNET_FLIGHT_DIR`` (span tree of the victim trace if known, the
    completed-request ring, the full metrics exposition, and MXNET_*
    config) and bump ``flight_bundles_total{trigger=...}``. Returns the
    bundle path, or None when disabled / over the per-process cap."""
    global _seq
    if not _enabled:
        return None
    tid = trace.trace_id if trace is not None else None
    with _lock:
        _triggers.append({"trigger": trigger, "trace_id": tid,
                          "ts": time.time(), "detail": dict(detail)})
        if len(_bundles_written) >= _max_bundles():
            capped = True
            path = None
        else:
            capped = False
            _seq += 1
            path = os.path.join(_dir(), "flight_%s_%d_%04d.json"
                                % (trigger, os.getpid(), _seq))
            _bundles_written.append(path)
        victim = list(_live.get(tid, ())) if tid else []
        ring = [dict(r) for r in _ring]
    if capped:
        registry.counter(
            "flight_bundles_dropped_total",
            "flight bundles skipped past MXNET_FLIGHT_MAX_BUNDLES").inc()
        return None
    bundle = {
        "trigger": trigger,
        "ts": time.time(),
        "pid": os.getpid(),
        "trace_id": tid,
        "request_id": (detail.get("request_id")
                       or (trace.request_id if trace is not None else None)),
        "detail": detail,
        "victim": _assemble(tid, victim, _ring_entry(ring, tid)),
        "recent_requests": ring,
        "metrics": registry.exposition(),
        "config": {k: v for k, v in os.environ.items()
                   if k.startswith("MXNET_")},
    }
    try:
        os.makedirs(_dir(), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        os.replace(tmp, path)
    except OSError:
        with _lock:
            if path in _bundles_written:
                _bundles_written.remove(path)
        return None
    registry.counter("flight_bundles_total",
                     "diagnostic bundles written by the flight recorder",
                     labels={"trigger": trigger}).inc()
    return path


def _ring_entry(ring: List[dict], trace_id: Optional[str]):
    if not trace_id:
        return None
    for r in reversed(ring):
        if r.get("trace_id") == trace_id:
            return r
    return None


# --- span-tree assembly ------------------------------------------------------
def _assemble(trace_id: Optional[str], spans: List[dict],
              completed: Optional[dict] = None) -> Optional[dict]:
    """Nest a flat span list into one tree via span_id/parent_id. Spans
    whose parent is unknown (root, or a batch span fanned in from
    another request's dispatch) become top-level children, ordered by
    start time — the tree is total even with a lossy ring."""
    if completed and not spans:
        spans = completed.get("spans", [])
    if trace_id is None and not spans:
        return None
    nodes: Dict[str, dict] = {}
    order: List[dict] = []
    for s in sorted(spans, key=lambda s: s.get("ts_ns", 0)):
        a = s.get("args") or {}
        node = dict(s)
        node["children"] = []
        sid = a.get("span_id")
        if sid:
            nodes.setdefault(sid, node)
        order.append(node)
    roots: List[dict] = []
    for node in order:
        a = node.get("args") or {}
        parent = nodes.get(a.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    out = {"trace_id": trace_id, "spans": roots,
           "n_spans": len(order)}
    if completed:
        for k in ("request_id", "ok", "code", "latency_ms", "kind"):
            out[k] = completed.get(k)
    return out


def request_tree(ident: str) -> Optional[dict]:
    """Assemble the span tree for a request id OR trace id — completed
    ring first (most recent wins), then the live table."""
    with _lock:
        for r in reversed(_ring):
            if ident in (r.get("request_id"), r.get("trace_id")):
                return _assemble(r.get("trace_id"),
                                 list(r.get("spans", ())), dict(r))
        spans = _live.get(ident)
        if spans is not None:
            return _assemble(ident, list(spans))
        for tid, spans in _live.items():
            if any((s.get("args") or {}).get("request_id") == ident
                   for s in spans):
                return _assemble(tid, list(spans))
    return None


def summary() -> dict:
    """Recorder state: recent completed requests (ids and outcome, no
    span bodies), the trigger history, the bundle paths written by this
    process."""
    with _lock:
        ring = [{k: r.get(k) for k in ("request_id", "trace_id", "ok",
                                       "code", "latency_ms", "kind", "ts")}
                for r in _ring]
        return {
            "enabled": _enabled,
            "dir": _dir(),
            "ring": ring,
            "live_traces": len(_live),
            "triggers": list(_triggers),
            "bundles": list(_bundles_written),
        }


def reset():
    """Drop all recorder state and re-read the env knobs (tests)."""
    global _ring, _seq, _enabled
    with _lock:
        _live.clear()
        _ring = deque(maxlen=max(1, int(
            os.environ.get("MXNET_FLIGHT_RING", "256"))))
        _bundles_written.clear()
        _triggers.clear()
        _seq = 0
    _enabled = (os.environ.get("MXNET_FLIGHT_RECORDER", "1") != "0"
                and os.environ.get("MXNET_TELEMETRY", "1") != "0")
