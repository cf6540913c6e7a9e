"""Central metrics registry: counters, gauges, histograms.

Counterpart of ``mxnet_tpu/telemetry/metrics.py``. The surface keeps
metric.py's ``get_name_value()`` convention (parallel name/value lists
zipped into pairs) and adds ``exposition()``, the Prometheus text format
(0.0.4; histograms observed with an exemplar carry OpenMetrics exemplars
on their bucket lines).

Counters are ON by default (``MXNET_TELEMETRY=0`` turns every mutation
into a branch-and-return); unlike spans they need no domain selection:
an ``inc()`` is one lock and an add.

Locking: ``Registry._lock`` guards only the name -> metric tables; renders
and reads snapshot the tables under the lock and evaluate metric values
(gauge callbacks and adopted groups are user code) outside it.
"""
from __future__ import annotations

import math
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .tracer import _master_enabled

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: the Prometheus text exposition content type (text format 0.0.4), the
#: one constant a ``/metrics`` response and a scraper agree on
CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if name and not name[0].isdigit() else "_" + name


class Counter:
    """Monotonic counter (``get_name_value()`` → one pair).

    Optional ``labels`` make this one SERIES of a labeled family — the
    registry keys labeled counters by ``name{k="v"}`` (same contract as
    labeled gauges; the unlabeled spelling is unchanged)."""

    __slots__ = ("name", "help", "_value", "_lock", "labels")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()
        self.labels = dict(labels) if labels else None

    def sample_name(self) -> str:
        return self.name + _render_labels(self.labels)

    def inc(self, n=1):
        if not _master_enabled():
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def get_name_value(self):
        return [(self.sample_name(), self._value)]


def _escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline (the only three escapes the 0.0.4 grammar has)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(labels) -> str:
    """``{k="v",...}`` suffix, keys sorted (stable registry identity)."""
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (_sanitize(str(k)), _escape_label_value(v))
        for k, v in sorted(labels.items()))


class Gauge:
    """Point-in-time value: either ``set()`` explicitly or computed by a
    callback ``fn`` at read time (e.g. the engine's pending-op depth).

    Optional ``labels`` make this one SERIES of a labeled family — the
    registry keys labeled gauges by ``name{k="v"}``, so
    ``gauge("kv_bytes", labels={"dtype": "int8"})`` and the unlabeled
    ``gauge("kv_bytes")`` are distinct metrics (the unlabeled spelling is
    bitwise unchanged by this feature)."""

    __slots__ = ("name", "help", "_value", "_fn", "labels")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None,
                 help: str = "", labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self._value = 0.0
        self._fn = fn
        self.labels = dict(labels) if labels else None

    def sample_name(self) -> str:
        return self.name + _render_labels(self.labels)

    def set(self, v):
        if not _master_enabled():
            return
        self._value = v

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return float("nan")
        return self._value

    def get_name_value(self):
        return [(self.sample_name(), self.value)]


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics).

    ``observe(v, exemplar="<trace_id>")`` attaches an OpenMetrics
    exemplar to the bucket the observation lands in (last-write-wins
    per bucket): the exposition then renders
    ``... # {trace_id="..."} <value> <unix_ts>`` after the bucket
    sample, which is how a Prometheus latency bucket links back to one
    concrete request timeline in the flight recorder."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_exemplars", "_lock")

    DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                      250, 500, 1000)

    def __init__(self, name: str, buckets: Sequence[float] = (),
                 help: str = ""):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets)) or self.DEFAULT_BUCKETS
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._exemplars: List[Optional[tuple]] = \
            [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: Optional[str] = None):
        if not _master_enabled():
            return
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar:
                self._exemplars[i] = (str(exemplar), float(v), time.time())

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> List[Optional[tuple]]:
        """Per-bucket ``(trace_id, value, unix_ts)`` or None (last
        slot is the +Inf bucket)."""
        with self._lock:
            return list(self._exemplars)

    def get_name_value(self):
        counts, s, n = self.snapshot()
        return [("%s_sum" % self.name, s), ("%s_count" % self.name, n)]


class Registry:
    """Process-wide metric registry (``telemetry.registry`` singleton).

    ``counter``/``gauge``/``histogram`` are get-or-create by name.
    ``register_group(prefix, obj)`` adopts an object exposing
    ``get_name_value()`` (the metric.py convention — e.g. a live
    ``ServingMetrics``) wholesale: the registry holds only a weakref, so
    short-lived servers don't leak, and each instance gets a stable
    ``sid`` label in the exposition.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._groups: List[Tuple[str, int, "weakref.ref"]] = []
        self._next_sid = 0

    def _get_or_create(self, name, cls, *args, key=None, **kwargs):
        key = key or name
        with self._lock:
            m = self._metrics.get(key)
        if m is None:
            # construct outside the lock (lockorder: no callable runs under
            # _lock); a racing creator loses benignly to setdefault
            fresh = cls(name, *args, **kwargs)
            with self._lock:
                m = self._metrics.setdefault(key, fresh)
        if not isinstance(m, cls):
            raise TypeError("metric %r already registered as %s"
                            % (name, type(m).__name__))
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        """Labeled counters are keyed by ``name{k="v"}`` — each label set
        is its own series (same contract as :meth:`gauge`)."""
        return self._get_or_create(name, Counter, help, labels,
                                   key=name + _render_labels(labels))

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        """Labeled gauges are keyed by ``name{k="v"}`` — each label set is
        its own series; omitting ``labels`` keeps the historical
        single-series behavior."""
        return self._get_or_create(name, Gauge, fn, help, labels,
                                   key=name + _render_labels(labels))

    def histogram(self, name: str, buckets: Sequence[float] = (),
                  help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, buckets, help)

    def register_group(self, prefix: str, obj) -> int:
        """Adopt ``obj.get_name_value()`` under ``prefix`` (weakref'd);
        returns the instance's ``sid`` label value."""
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._groups.append((prefix, sid, weakref.ref(obj)))
            return sid

    # --- reads (no user code under _lock) --------------------------------
    def _snapshot(self):
        with self._lock:
            metrics = list(self._metrics.values())
            groups = list(self._groups)
        live = []
        dead = False
        for prefix, sid, ref in groups:
            obj = ref()
            if obj is None:
                dead = True
            else:
                live.append((prefix, sid, obj))
        if dead:  # prune collected groups so the table stays bounded
            with self._lock:
                self._groups = [g for g in self._groups if g[2]() is not None]
        return metrics, live

    def get(self):
        """(names, values) — metric.py's EvalMetric.get() shape, covering
        registry metrics and live groups (group entries as
        ``<prefix>_<name>``)."""
        metrics, groups = self._snapshot()
        names, values = [], []
        for m in metrics:
            for n, v in m.get_name_value():
                names.append(n)
                values.append(v)
        for prefix, _sid, obj in groups:
            for n, v in obj.get_name_value():
                names.append("%s_%s" % (prefix, _sanitize(str(n))))
                values.append(v)
        return names, values

    def get_name_value(self):
        names, values = self.get()
        return list(zip(names, values))

    def exposition(self) -> str:
        """Render the Prometheus text exposition format (0.0.4 — serve it
        with ``CONTENT_TYPE_LATEST``). EVERY family gets a ``# HELP`` and
        a ``# TYPE`` line, emitted once per family (labeled gauge series
        and group instances share theirs); families without declared help
        fall back to the family name, so scrapers always see well-formed
        framing. Gauge callbacks and group ``get_name_value()`` run
        outside the registry lock."""
        metrics, groups = self._snapshot()
        out: List[str] = []
        headed = set()  # families whose HELP/TYPE already went out

        def _head(name: str, kind: str, help_text: str):
            if name in headed:
                return
            headed.add(name)
            out.append("# HELP %s %s"
                       % (name, (help_text or name)
                          .replace("\\", "\\\\").replace("\n", "\\n")))
            out.append("# TYPE %s %s" % (name, kind))

        for m in metrics:
            name = _sanitize(m.name)
            if isinstance(m, Counter):
                _head(name, "counter", m.help)
                out.append("%s%s %s" % (name, _render_labels(m.labels),
                                        _fmt(m.value)))
            elif isinstance(m, Gauge):
                _head(name, "gauge", m.help)
                out.append("%s%s %s" % (name, _render_labels(m.labels),
                                        _fmt(m.value)))
            elif isinstance(m, Histogram):
                _head(name, "histogram", m.help)
                counts, s, n = m.snapshot()
                ex = m.exemplars()
                acc = 0
                for i, (b, c) in enumerate(zip(m.buckets, counts)):
                    acc += c
                    out.append('%s_bucket{le="%s"} %d%s'
                               % (name, _fmt(b), acc, _fmt_exemplar(ex[i])))
                out.append('%s_bucket{le="+Inf"} %d%s'
                           % (name, n, _fmt_exemplar(ex[-1])))
                out.append("%s_sum %s" % (name, _fmt(s)))
                out.append("%s_count %d" % (name, n))
        for prefix, sid, obj in groups:
            for n, v in obj.get_name_value():
                fam = "%s_%s" % (_sanitize(prefix), _sanitize(str(n)))
                _head(fam, "gauge", "")
                out.append('%s{sid="%d"} %s' % (fam, sid, _fmt(v)))
        return "\n".join(out) + "\n"

    def reset(self):
        """Drop every metric and group (tests)."""
        with self._lock:
            self._metrics.clear()
            self._groups.clear()


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix — `` # {trace_id="..."} v ts`` —
    or the empty string. Exemplars exist only in the OpenMetrics
    grammar; they appear solely on ``_bucket`` lines of histograms
    that were observed WITH an exemplar, so every other family stays
    bitwise 0.0.4."""
    if not ex:
        return ""
    tid, v, ts = ex
    return ' # {trace_id="%s"} %s %s' % (
        _escape_label_value(tid), _fmt(v), repr(float(ts)))


def _fmt(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


#: the process-wide registry (``telemetry.registry``)
registry = Registry()
