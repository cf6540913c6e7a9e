"""Runtime compile witness.

Counterpart of ``mxnet_tpu/analysis/compile_witness.py``.
``MXNET_COMPILE_WITNESS=1`` (or :func:`enable`) arms a process-wide
recorder that every program surface of the port reports into:

- a **compile** is a fresh trace of a program: a ``predict.Predictor`` /
  ``quant.QuantizedPredictor`` bucket bound from its symbol (kind
  ``predictor`` / ``quant``; with the program cache on, the
  ``torch.export`` trace of its forward) and an ``engine.FusedSequence``
  stitched from its recorded ops (``fused``);
- a **disk load** is an entry read from ``progcache`` (``progcache.load``
  with a kind);
- a **capture** is a CUDA graph captured of a program already built (a
  bucket's forward, a fused sequence): counted apart, never a compile.

After :func:`steady_state` (the phase marker a server flips once warm-up
is done) any fresh compile is a violation, kept with the stack that caused
it. Disabled (the default) every hook is one branch and a return.

The counters surface on the telemetry registry as
``compiles_total{kind="..."}``, ``graph_captures_total{kind="..."}`` and
``compiles_after_steady_total``. ``_lock`` is a leaf: nothing is acquired
under it and the registry increments happen after its release.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional

_TRUTHY = ("1", "true", "yes", "on")

_enabled = os.environ.get("MXNET_COMPILE_WITNESS",
                          "").strip().lower() in _TRUTHY

_lock = threading.Lock()
_tls = threading.local()

#: record/violation lists are bounded; the counts stay exact past the cap
MAX_RECORDS = 512

_records: List[dict] = []
_violations: List[dict] = []
_counts: Dict[str, int] = {}        # kind -> fresh program traces
_disk_counts: Dict[str, int] = {}   # kind -> progcache disk loads
_capture_counts: Dict[str, int] = {}  # kind -> CUDA graph captures
_scope_counts: Dict[tuple, int] = {}  # (scope, "compile"|"disk") -> n
_steady = False
_after_steady = 0
_scope_counter = [0]


def enabled() -> bool:
    """True when the witness records (env ``MXNET_COMPILE_WITNESS=1`` or a
    programmatic :func:`enable`)."""
    return _enabled


def enable(on: bool = True) -> bool:
    """Programmatic arm/disarm (tests and the bench overhead arm — the
    env var is the production switch). Returns the previous state."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def new_scope() -> int:
    """A fresh scope token: surfaces that want a per-instance compile /
    disk-load split (BucketCache) tag their builds with
    one and read it back via :func:`scope_counts`."""
    with _lock:
        _scope_counter[0] += 1
        return _scope_counter[0]


class _NullSurface:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SURFACE = _NullSurface()


class _Surface:
    __slots__ = ("scope",)

    def __init__(self, scope: int):
        self.scope = scope

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.scope)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def surface(scope: int):
    """Context manager tagging compiles/disk loads recorded on THIS thread
    with ``scope`` (e.g. BucketCache wraps its ``reshape`` calls so the
    inner Predictor compile lands in the cache's scope counts). Acquires
    no lock — a thread-local push/pop; a no-op singleton when disabled."""
    if not _enabled:
        return _NULL_SURFACE
    return _Surface(scope)


def _current_scope(scope: Optional[int]) -> Optional[int]:
    if scope is not None:
        return scope
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _capture_stack() -> List[str]:
    frames = traceback.extract_stack(limit=16)[:-2]
    return ["%s:%d %s" % (os.path.basename(f.filename), f.lineno or 0,
                          f.name) for f in frames]


def _export(kind: str, steady: bool):
    # telemetry counters increment outside _lock (leaf discipline)
    try:
        from ..telemetry.metrics import registry
    except Exception:
        return
    registry.counter(
        "compiles_total",
        help="fresh program traces recorded by the compile witness",
        labels={"kind": kind}).inc()
    if steady:
        registry.counter(
            "compiles_after_steady_total",
            help="fresh program traces after witness.steady_state() — any "
                 "nonzero value is a recompile-storm violation").inc()
        # a steady-state recompile is exactly the anomaly the flight
        # recorder exists for: snapshot the serving picture around it
        try:
            from ..telemetry import flight

            flight.on_anomaly("compile_after_steady", kind=kind)
        except Exception:
            pass


def record_compile(kind: str, key: str = "", shapes: str = "",
                   scope: Optional[int] = None):
    """One fresh trace of a program on surface ``kind``. After
    :func:`steady_state` this is a violation and keeps the causing stack.
    Disabled: one branch."""
    global _after_steady
    if not _enabled:
        return
    scope = _current_scope(scope)
    rec = {"kind": kind, "key": str(key)[:96], "shapes": str(shapes)[:256],
           "stack": _capture_stack()}
    with _lock:
        steady = _steady
        rec["after_steady"] = steady
        _counts[kind] = _counts.get(kind, 0) + 1
        if scope is not None:
            sk = (scope, "compile")
            _scope_counts[sk] = _scope_counts.get(sk, 0) + 1
        if len(_records) < MAX_RECORDS:
            _records.append(rec)
        if steady:
            _after_steady += 1
            if len(_violations) < MAX_RECORDS:
                _violations.append(rec)
    _export(kind, steady)


def record_disk_load(kind: str, key: str = "",
                     scope: Optional[int] = None):
    """One progcache disk load on surface ``kind`` — never a violation
    (warm restarts disk-load the whole program set by design)."""
    if not _enabled:
        return
    scope = _current_scope(scope)
    with _lock:
        _disk_counts[kind] = _disk_counts.get(kind, 0) + 1
        if scope is not None:
            sk = (scope, "disk")
            _scope_counts[sk] = _scope_counts.get(sk, 0) + 1


def record_capture(kind: str, key: str = ""):
    """One CUDA graph captured of a program already built on surface
    ``kind`` — never a compile and never a violation."""
    if not _enabled:
        return
    with _lock:
        _capture_counts[kind] = _capture_counts.get(kind, 0) + 1
    try:
        from ..telemetry.metrics import registry
    except Exception:
        return
    registry.counter(
        "graph_captures_total",
        help="CUDA graphs captured of built programs (compile witness)",
        labels={"kind": kind}).inc()


def steady_state():
    """Flip the phase marker: warmup is over, the program set is closed.
    Every fresh compile recorded after this call is a violation."""
    global _steady
    if not _enabled:
        return
    with _lock:
        _steady = True
    try:
        # materialize the counter at 0 so scrapers see the gauge before
        # the first (never, ideally) violation
        from ..telemetry.metrics import registry
        registry.counter(
            "compiles_after_steady_total",
            help="fresh program traces after witness.steady_state() — any "
                 "nonzero value is a recompile-storm violation")
    except Exception:
        pass


def in_steady_state() -> bool:
    return _steady


def compiles_total(kind: Optional[str] = None) -> int:
    with _lock:
        if kind is not None:
            return _counts.get(kind, 0)
        return sum(_counts.values())


def disk_loads_total(kind: Optional[str] = None) -> int:
    with _lock:
        if kind is not None:
            return _disk_counts.get(kind, 0)
        return sum(_disk_counts.values())


def captures_total(kind: Optional[str] = None) -> int:
    with _lock:
        if kind is not None:
            return _capture_counts.get(kind, 0)
        return sum(_capture_counts.values())


def compiles_after_steady_total() -> int:
    with _lock:
        return _after_steady


def violations() -> List[dict]:
    """Fresh compiles recorded after :func:`steady_state`, each with the
    host stack that caused it."""
    with _lock:
        return [dict(v) for v in _violations]


def scope_counts(scope: int) -> Dict[str, int]:
    """``{"compiles": n, "disk_hits": n}`` recorded under ``scope``."""
    with _lock:
        return {"compiles": _scope_counts.get((scope, "compile"), 0),
                "disk_hits": _scope_counts.get((scope, "disk"), 0)}


def compile_witness_report() -> dict:
    """The full witness state: per-kind compile/disk-load counts, the
    steady-state flag, and every violation with its stack."""
    with _lock:
        return {
            "enabled": _enabled,
            "steady": _steady,
            "compiles": dict(_counts),
            "disk_loads": dict(_disk_counts),
            "captures": dict(_capture_counts),
            "compiles_total": sum(_counts.values()),
            "disk_loads_total": sum(_disk_counts.values()),
            "compiles_after_steady_total": _after_steady,
            "violations": [dict(v) for v in _violations],
            "records": [dict(r) for r in _records],
        }


def reset():
    """Clear records and drop the steady-state marker (tests; dryruns
    that exercise several serving phases in one process)."""
    global _steady, _after_steady
    with _lock:
        _records.clear()
        _violations.clear()
        _counts.clear()
        _disk_counts.clear()
        _capture_counts.clear()
        _scope_counts.clear()
        _steady = False
        _after_steady = 0
