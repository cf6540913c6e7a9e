"""Lock-light host-side trace recorder.

Counterpart of ``mxnet_tpu/telemetry/tracer.py`` (the reference profiler,
src/engine/profiler.cc, stamps per-op begin/end inside engine workers into
per-thread blocks and merges them at dump time). The same design:

- every thread appends events to its OWN ring buffer (a bounded
  ``collections.deque``; appends are GIL-atomic, no lock on the hot
  path); buffers register themselves in a global list once, under a
  lock, at first use;
- ``drain_events()``/``chrome_events()`` walk all buffers at dump time
  (the only cross-thread read, done with ``popleft`` so concurrent
  appends are never lost);
- the disabled path is a branch-and-return: ``span()`` returns a no-op
  singleton unless the event's *domain* was enabled.

Domains (``engine``, ``serving``, ``executor``, ...) are selected with
``MXNET_PROFILER=engine,serving`` (or ``1``/``all``); spans are OFF by
default. ``MXNET_TELEMETRY=0`` is the master kill for the whole
subsystem; ``MXNET_TELEMETRY_BUFFER`` sizes each thread's ring.

Timestamps use ``time.monotonic_ns()``, the clock of the serving
deadlines (``time.monotonic``), so request queue time can be rebuilt
exactly with ``complete()``. ``profiler.dump_profile`` moves the device
events of a ``torch.profiler`` trace onto this clock.

Instrumentation stays OUTSIDE a captured CUDA graph: the Python body of
a captured step runs at its warm-up calls and its capture, never at a
replay, so a span inside it would be recorded a few times and then no
more. Every span of the port sits on the host side of a replay.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: per-thread ring size default (events beyond it age out oldest-first).
#: MXNET_TELEMETRY_BUFFER is re-read at every ring CREATION — a test or
#: forked worker can resize without reimporting; threads whose rings
#: already exist keep their size.
_BUFFER_SIZE = int(os.environ.get("MXNET_TELEMETRY_BUFFER", "65536"))


def _buffer_size() -> int:
    try:
        return int(os.environ.get("MXNET_TELEMETRY_BUFFER") or _BUFFER_SIZE)
    except ValueError:
        return _BUFFER_SIZE

clock_ns = time.monotonic_ns


def _master_enabled() -> bool:
    return os.environ.get("MXNET_TELEMETRY", "1") != "0"


# --- per-thread buffers ------------------------------------------------------
class _ThreadBuffer:
    __slots__ = ("events", "tid", "name")

    def __init__(self):
        self.events: deque = deque(maxlen=_buffer_size())
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.name = t.name


_local = threading.local()
_buffers: List[_ThreadBuffer] = []
_buffers_lock = threading.Lock()


def _buf() -> _ThreadBuffer:
    b = getattr(_local, "buf", None)
    if b is None:
        b = _ThreadBuffer()
        _local.buf = b
        with _buffers_lock:
            _buffers.append(b)
    return b


# --- domain gating -----------------------------------------------------------
_spans_on = False
_all_domains = False
_domains: frozenset = frozenset()


def enable_spans(domains: str = "all"):
    """Turn span recording on for a comma-separated domain list (``"all"``
    or ``"1"`` enables every domain). No-op under ``MXNET_TELEMETRY=0``."""
    global _spans_on, _all_domains, _domains
    if not _master_enabled():
        return
    toks = [t for t in str(domains).replace(" ", "").split(",") if t]
    _all_domains = any(t in ("all", "1", "*") for t in toks)
    _domains = frozenset(toks)
    _spans_on = bool(toks)


def disable_spans():
    global _spans_on, _all_domains, _domains
    _spans_on = False
    _all_domains = False
    _domains = frozenset()


def enabled(domain: str) -> bool:
    """Fast probe: is span recording on for this domain? Call sites use it
    to skip building span arguments entirely on the disabled path."""
    return _spans_on and (_all_domains or domain in _domains)


def enabled_domains() -> str:
    return "all" if _all_domains else ",".join(sorted(_domains))


# env default: MXNET_PROFILER=engine,serving (spans stay off when unset)
_env_profiler = os.environ.get("MXNET_PROFILER", "")
if _env_profiler and _env_profiler not in ("0", "off", "none"):
    enable_spans(_env_profiler)
del _env_profiler


# --- span sink (flight recorder tee) -----------------------------------------
_span_sink = None


def set_span_sink(fn):
    """Install ``fn(ph, name, domain, ts_ns, dur_ns, args)``, invoked on
    the recording thread for every completed event whose args carry
    ``trace_id``/``trace_ids`` stamps — the flight recorder's feed
    (telemetry.flight installs itself at import). Only runs when spans
    are ON: the disabled path never reaches it. Returns the prior sink."""
    global _span_sink
    prev = _span_sink
    _span_sink = fn
    return prev


def _tee(ph, name, domain, ts_ns, dur_ns, args):
    s = _span_sink
    if (s is None or args is None
            or ("trace_id" not in args and "trace_ids" not in args)):
        return
    try:
        s(ph, name, domain, ts_ns, dur_ns, args)
    except Exception:
        pass  # a broken sink must never take down the traced code


# --- event recording ---------------------------------------------------------
# raw event: (ph, name, domain, ts_ns, dur_ns, args_or_None)
class _Span:
    """Context manager recording one complete ("X") event."""

    __slots__ = ("name", "domain", "args", "t0")

    def __init__(self, name, domain, args):
        self.name = name
        self.domain = domain
        self.args = args or None

    def __enter__(self):
        self.t0 = clock_ns()
        return self

    def annotate(self, **args):
        """Attach/overwrite args discovered while the span is open."""
        self.args = dict(self.args or (), **args)
        return self

    def __exit__(self, *exc):
        t1 = clock_ns()
        _buf().events.append(
            ("X", self.name, self.domain, self.t0, t1 - self.t0, self.args))
        _tee("X", self.name, self.domain, self.t0, t1 - self.t0, self.args)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def annotate(self, **args):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, domain: str = "app", **args):
    """``with telemetry.span("engine.op", domain="engine", vars=3): ...``
    — records an "X" event on the calling thread's ring buffer. Returns a
    shared no-op object when the domain is disabled (branch-and-return;
    nothing is allocated)."""
    if not (_spans_on and (_all_domains or domain in _domains)):
        return _NOOP
    return _Span(name, domain, args)


def begin(name: str, domain: str = "app", **args) -> Optional[tuple]:
    """Start an async span; returns an opaque token (or None when the
    domain is disabled). Pass the token to :func:`end` from ANY thread —
    the completed event lands on the *beginning* thread's buffer, so one
    logical op stays on one trace row even when its ``on_complete`` fires
    elsewhere (the engine push_async shape)."""
    if not (_spans_on and (_all_domains or domain in _domains)):
        return None
    return (_buf(), name, domain, clock_ns(), args or None)


def end(token: Optional[tuple], **extra_args):
    """Finish an async span started with :func:`begin` (None-safe)."""
    if token is None:
        return
    buf, name, domain, t0, args = token
    if extra_args:
        args = dict(args or (), **extra_args)
    end_tid = threading.get_ident()
    if end_tid != buf.tid:
        args = dict(args or (), end_tid=end_tid)
    dur = clock_ns() - t0
    buf.events.append(("X", name, domain, t0, dur, args))
    _tee("X", name, domain, t0, dur, args)


def complete(name: str, domain: str = "app", start_ns: int = 0,
             end_ns: Optional[int] = None, **args):
    """Record an "X" event with EXPLICIT ``monotonic_ns`` timestamps —
    for lifecycle stages whose start was stamped elsewhere (e.g. serving
    queue time measured from ``Request.submitted``)."""
    if not (_spans_on and (_all_domains or domain in _domains)):
        return
    t1 = clock_ns() if end_ns is None else end_ns
    a = args or None
    _buf().events.append(
        ("X", name, domain, start_ns, max(0, t1 - start_ns), a))
    _tee("X", name, domain, start_ns, max(0, t1 - start_ns), a)


def instant(name: str, domain: str = "app", **args):
    """Record an instant ("i") event — a point-in-time marker."""
    if not (_spans_on and (_all_domains or domain in _domains)):
        return
    t = clock_ns()
    a = args or None
    _buf().events.append(("i", name, domain, t, 0, a))
    _tee("i", name, domain, t, 0, a)


def mark_begin(name: str, domain: str = "app", **args):
    """Emit a duration-begin ("B") event; pair with :func:`mark_end` ON
    THE SAME THREAD (chrome matches B/E per tid). Used for user-delimited
    windows like the profiler run/stop bracket."""
    if not (_spans_on and (_all_domains or domain in _domains)):
        return
    _buf().events.append(("B", name, domain, clock_ns(), 0, args or None))


def mark_end(name: str, domain: str = "app", **args):
    if not (_spans_on and (_all_domains or domain in _domains)):
        return
    _buf().events.append(("E", name, domain, clock_ns(), 0, args or None))


# --- drain / dump ------------------------------------------------------------
def drain_events(clear: bool = True) -> List[tuple]:
    """Collect raw events from every thread buffer as
    ``(ph, name, domain, ts_ns, dur_ns, args, tid, thread_name)`` tuples.
    ``clear=True`` (the default) empties the buffers with ``popleft`` so
    events appended concurrently are kept for the next drain, never lost."""
    with _buffers_lock:
        bufs = list(_buffers)
    out: List[tuple] = []
    for b in bufs:
        if clear:
            evs = []
            dq = b.events
            while True:
                try:
                    evs.append(dq.popleft())
                except IndexError:
                    break
        else:
            evs = list(b.events)
        for ev in evs:
            out.append(ev + (b.tid, b.name))
    return out


def chrome_events(clear: bool = True) -> List[dict]:
    """Drain to chrome://tracing ``traceEvents`` dicts (``ph`` "X"/"B"/
    "E"/"i", pid/tid, ts/dur in µs), preceded by ``thread_name`` metadata
    events, sorted so ts is monotonic per tid."""
    pid = os.getpid()
    raw = drain_events(clear=clear)
    seen_tids: Dict[int, str] = {}
    evs: List[dict] = []
    for ph, name, domain, ts_ns, dur_ns, args, tid, tname in raw:
        seen_tids.setdefault(tid, tname)
        e = {"name": name, "cat": domain, "ph": ph, "pid": pid, "tid": tid,
             "ts": ts_ns / 1000.0}
        if ph == "X":
            e["dur"] = dur_ns / 1000.0
        elif ph == "i":
            e["s"] = "t"
        if args:
            e["args"] = dict(args)
        evs.append(e)
    evs.sort(key=lambda e: (e["tid"], e["ts"]))
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}} for tid, tname in seen_tids.items()]
    return meta + evs


def dump_ring(dir: Optional[str] = None) -> Optional[str]:
    """Drain this process's ring buffers to a pid-tagged file
    ``<dir>/telemetry_ring_<pid>.json`` (a chrome ``traceEvents`` list;
    pid rides every event). A worker process calls this before it exits
    (``dir`` or ``MXNET_TELEMETRY_RING_DIR``), and
    ``profiler.dump_profile()`` merges every ring file it finds into the
    single trace. Returns the path, or None when no directory is
    configured."""
    import json

    d = dir or os.environ.get("MXNET_TELEMETRY_RING_DIR")
    if not d:
        return None
    evs = chrome_events(clear=True)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "telemetry_ring_%d.json" % os.getpid())
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(evs, f)
    os.replace(tmp, path)
    return path


def reset():
    """Drop every buffered event (buffers stay registered)."""
    drain_events(clear=True)
