"""mxnet_tpu_torch.telemetry: process-wide tracing and metrics.

Counterpart of ``mxnet_tpu/telemetry/``. Four pieces, each with a
branch-and-return disabled path:

- **tracing** (:mod:`.tracer`): per-thread ring-buffer span recorder.
  Spans are OFF by default; enable domains with
  ``MXNET_PROFILER=engine,serving,executor`` (or ``all``), or with
  :func:`enable_spans`. ``profiler.dump_profile()`` drains every buffer
  into one chrome://tracing JSON beside the device's events.
- **metrics** (:mod:`.metrics`): the central :data:`registry` of
  counters, gauges and histograms plus adopted metric groups
  (``serving.metrics.ServingMetrics``), with ``get_name_value()`` and the
  Prometheus ``exposition()`` (histograms carry OpenMetrics exemplars
  linking buckets to traces). Counters are ON by default;
  ``MXNET_TELEMETRY=0`` kills everything.
- **trace context** (:mod:`.context`): W3C ``traceparent`` parse and
  mint, the thread-local and per-request carry, and the
  ``trace_id`` / ``span_id`` / ``parent_id`` span stamps.
- **flight recorder** (:mod:`.flight`): an always-on bounded ring of
  completed request timelines; SLO anomalies (a deadline miss,
  ``MXNET_SLOW_REQUEST_MS``) write diagnostic bundles to
  ``MXNET_FLIGHT_DIR``.

Instrumentation lives outside captured CUDA graphs: a span, counter or
gauge sits on the host side of a replay, never in the captured body.
"""
from .tracer import (begin, chrome_events, clock_ns, complete,
                     disable_spans, drain_events, dump_ring, enable_spans,
                     enabled, enabled_domains, end, instant, mark_begin,
                     mark_end, reset, set_span_sink, span)
from .metrics import (CONTENT_TYPE_LATEST, Counter, Gauge, Histogram,
                      Registry, registry)
from . import context
from . import flight
from .context import TraceContext, current_context

__all__ = [
    "span", "begin", "end", "complete", "instant", "mark_begin", "mark_end",
    "enabled", "enable_spans", "disable_spans", "enabled_domains",
    "drain_events", "chrome_events", "clock_ns", "reset", "dump_ring",
    "set_span_sink",
    "registry", "Registry", "Counter", "Gauge", "Histogram",
    "CONTENT_TYPE_LATEST",
    "context", "flight", "TraceContext", "current_context",
]
