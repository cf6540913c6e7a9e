"""mxnet_tpu_torch.telemetry, profiler and serving.metrics against the JAX
package's.

Each scenario makes the same calls on the tracer, the metrics registry,
the trace context or the flight recorder of both packages and compares
what they give back, with the values that cannot agree (clocks, thread
ids, random span ids) replaced by their shape: chrome events (phase,
name, domain, args, order a thread), ring bounds, the Prometheus
exposition byte for byte, traceparent parsing, flight trees, bundles and
thresholds. Then the port's own pieces: ``profiler.dump_profile`` (always
writes, host spans and the CPU device half in one file), the engine's
spans and pending gauge, ``ServingMetrics``' adoption and the quantized
bytes gauge.

Every test starts and ends with spans off, empty buffers and a reset
flight recorder in both packages, and runs against fresh registries
(the process-wide ones are swapped out for the test, never reset), so
no state crosses into the tests after it.
"""
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serving import metrics as jsmetrics
from mxnet_tpu.telemetry import context as jctx
from mxnet_tpu.telemetry import flight as jflight
from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.telemetry import tracer as jtracer
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.serving import metrics as tsmetrics
from mxnet_tpu_torch.telemetry import context as tctx
from mxnet_tpu_torch.telemetry import flight as tflight
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.telemetry import tracer as ttracer

# (telemetry, context, flight, metrics module, tracer module) of a package
JAX = (jtel, jctx, jflight, jmetrics, jtracer)
TORCH = (ttel, tctx, tflight, tmetrics, ttracer)
# the process-wide registries, swapped out during each test
PROCESS_REGISTRY = (jmetrics.registry, tmetrics.registry)


def fresh_registries(monkeypatch):
    """Swap each package's process-wide registry for a fresh one for the
    test (monkeypatch restores them): the scheduler, the flight recorder
    and the latency histogram all reach it by these names."""
    regs = []
    for tel, _ctx, flight, metrics, _tr in (JAX, TORCH):
        reg = metrics.Registry()
        monkeypatch.setattr(tel, "registry", reg)
        monkeypatch.setattr(metrics, "registry", reg)
        monkeypatch.setattr(flight, "registry", reg)
        regs.append(reg)
    return regs


def clean_telemetry():
    for tel, _ctx, flight, _m, _tr in (JAX, TORCH):
        tel.disable_spans()
        tel.reset()
        flight.reset()


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "flight"))
    fresh_registries(monkeypatch)
    clean_telemetry()
    yield
    clean_telemetry()


def _shape(value):
    """A value whose exact bits differ between runs, by kind."""
    if isinstance(value, str) and len(value) in (16, 32):
        try:
            int(value, 16)
            return "hex%d" % len(value)
        except ValueError:
            pass
    return value


def _args(args):
    if not args:
        return args
    out = {}
    for k, v in args.items():
        if k == "end_tid":
            out[k] = "tid"
        elif k == "trace_ids":
            out[k] = [_shape(x) for x in v]
        else:
            out[k] = _shape(v)
    return out


def _chrome(events):
    """Chrome events without clocks and thread ids: each thread's events in
    order, the threads in the order of their first event, and the keys of
    every event."""
    rows, keys = {}, []
    for e in events:
        keys.append(tuple(sorted(e)))
        row = rows.setdefault(e["tid"], [])
        if e["ph"] == "M":
            row.append(("M", e["name"], e["args"]["name"]))
            continue
        row.append((e["ph"], e["name"], e["cat"], _args(e.get("args"))))
    return list(rows.values()), keys


def _per_tid_sorted(events):
    last = {}
    for e in events:
        if e["ph"] == "M":
            continue
        assert e["ts"] >= last.get(e["tid"], float("-inf"))
        last[e["tid"]] = e["ts"]


# --- tracer ------------------------------------------------------------------

def _scenario_spans(tel):
    tel.enable_spans("engine,serving")
    with tel.span("op1", domain="engine", vars=3) as sp:
        sp.annotate(extra="y")
        with tel.span("inner", domain="serving", rows=2):
            pass
    with tel.span("hidden", domain="kvstore"):
        pass
    tel.instant("mark", domain="serving", why="x")


def _scenario_threads(tel):
    tel.enable_spans("all")
    tok = tel.begin("engine.async", domain="engine", key=7)
    done = threading.Event()

    def other():
        with tel.span("worker", domain="engine"):
            pass
        tel.end(tok, status="ok")
        done.set()

    t = threading.Thread(target=other, name="telemetry-worker")
    t.start()
    t.join(10)
    assert done.is_set()
    tel.end(None)


def _scenario_complete(tel):
    tel.enable_spans("serving")
    now = tel.clock_ns()
    tel.complete("serving.queued", domain="serving",
                 start_ns=now - 5_000_000, end_ns=now, tokens=4)
    tel.complete("future", domain="serving", start_ns=now + 10**9,
                 end_ns=now)
    tel.complete("skipped", domain="engine", start_ns=now)
    tel.mark_begin("window", domain="serving", run=1)
    tel.mark_end("window", domain="serving")


@pytest.mark.parametrize("scenario", [_scenario_spans, _scenario_threads,
                                      _scenario_complete])
def test_chrome_events_match_the_reference(scenario):
    got = {}
    for pkg in (JAX, TORCH):
        tel = pkg[0]
        scenario(tel)
        tel.disable_spans()
        evs = tel.chrome_events()
        _per_tid_sorted(evs)
        assert tel.chrome_events() == []          # drained
        got[pkg[0].__name__] = _chrome(evs)
        durs = [e["dur"] for e in evs if e["ph"] == "X"]
        assert all(d >= 0 for d in durs)
    assert got["mxnet_tpu_torch.telemetry"] == got["mxnet_tpu.telemetry"]


def test_raw_events_carry_phase_name_domain_args_and_thread():
    for tel in (jtel, ttel):
        tel.enable_spans("engine")
        with tel.span("op1", domain="engine", vars=3) as sp:
            sp.annotate(extra="y")
        (ev,) = tel.drain_events()
        ph, name, domain, ts, dur, args, tid, tname = ev
        assert (ph, name, domain, args) == ("X", "op1", "engine",
                                            {"vars": 3, "extra": "y"})
        assert dur >= 0 and tid == threading.get_ident()


@pytest.mark.parametrize("domains", ["all", "1", "*", "engine,serving",
                                     " serving , engine ", "", "executor"])
def test_domain_gating_matches_the_reference(domains):
    seen = []
    for tel in (jtel, ttel):
        tel.enable_spans(domains)
        seen.append((tel.enabled_domains(),
                     [tel.enabled(d) for d in ("engine", "serving",
                                               "executor", "other")]))
        # the disabled path hands out one shared no-op object
        assert tel.span("a", domain="off-domain-x") is \
            tel.span("b", domain="off-domain-y") or domains in ("all", "1",
                                                                 "*")
        tel.disable_spans()
        assert not tel.enabled("engine")
    assert seen[0] == seen[1]


def test_master_kill_switch_matches_the_reference(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    for tel, metrics in ((jtel, jmetrics), (ttel, tmetrics)):
        tel.enable_spans("all")
        assert not tel.enabled("engine")
        reg = metrics.Registry()
        c, h, g = reg.counter("k_total"), reg.histogram("k_h"), reg.gauge("g")
        c.inc(5)
        h.observe(1.0)
        g.set(3)
        assert (c.value, h.snapshot()[2], g.value) == (0, 0, 0.0)


def test_ring_bounds_and_buffer_size_match_the_reference(monkeypatch):
    """``MXNET_TELEMETRY_BUFFER`` is read when a thread's ring is made: a
    ring keeps its newest events, a malformed size falls back to the
    default."""
    out = []
    for tel, tracer in ((jtel, jtracer), (ttel, ttracer)):
        tel.enable_spans("all")
        sizes = []
        for env in ("32", "not-a-number"):
            monkeypatch.setenv("MXNET_TELEMETRY_BUFFER", env)

            def work():
                sizes.append(tracer._buf().events.maxlen)
                for i in range(50):
                    tel.instant("e%d" % i, domain="x")

            t = threading.Thread(target=work)
            t.start()
            t.join(10)
            assert not t.is_alive()
            names = [e[1] for e in tel.drain_events()]
            sizes.append(names)
        out.append(sizes)
        assert out[-1][0] == 32 and out[-1][1] == ["e%d" % i
                                                   for i in range(18, 50)]
        assert out[-1][2] == tracer._BUFFER_SIZE
    assert out[0] == out[1]


def test_span_sink_sees_stamped_events_and_survives_a_broken_sink():
    got = []
    for tel in (jtel, ttel):
        seen = []
        prev = tel.set_span_sink(lambda *a, seen=seen: seen.append(a[:3]))
        try:
            tel.enable_spans("serving")
            with tel.span("plain", domain="serving"):
                pass
            with tel.span("stamped", domain="serving", trace_id="t"):
                pass
            tel.instant("fan", domain="serving", trace_ids=["a", "b"])
            tel.set_span_sink(lambda *a: 1 / 0)
            with tel.span("after", domain="serving", trace_id="t"):
                pass
        finally:
            tel.set_span_sink(prev)
        got.append(seen)
        assert [e[1] for e in tel.drain_events()] == [
            "plain", "stamped", "fan", "after"]
    assert got[0] == got[1] == [("X", "stamped", "serving"),
                                ("i", "fan", "serving")]


def test_dump_ring_writes_a_pid_tagged_chrome_list(tmp_path):
    paths = []
    for tel in (jtel, ttel):
        assert tel.dump_ring() is None or os.environ.get(
            "MXNET_TELEMETRY_RING_DIR")
        tel.enable_spans("all")
        with tel.span("ringed", domain="engine"):
            pass
        d = tmp_path / tel.__name__
        path = tel.dump_ring(str(d))
        assert os.path.basename(path) == "telemetry_ring_%d.json" % \
            os.getpid()
        with open(path) as f:
            evs = json.load(f)
        paths.append(_chrome(evs))
    assert paths[0] == paths[1]


# --- metrics -----------------------------------------------------------------

# a line of the text format: HELP / TYPE, or a sample (name, labels,
# value) with an optional OpenMetrics exemplar
PROM_LINE = re.compile(
    r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\\n]|'
    r'\\[\\"n])*",?)*\})? (NaN|[-+]?[0-9.e+-]+|[-+]Inf)'
    r'( # \{trace_id="[^"]*"\} [-+0-9.e]+ [0-9.e+]+)?)$')


def _exp_counters(reg):
    c = reg.counter("requests_total", help="requests seen")
    c.inc()
    c.inc(4)
    reg.counter("flight_bundles_total", labels={"trigger": "shed"}).inc()
    reg.counter("flight_bundles_total",
                labels={"trigger": "deadline_miss"}).inc(2)
    assert reg.counter("requests_total") is c
    reg.counter("9starts-with.digit").inc(3)


def _exp_gauges(reg):
    reg.gauge("kv_bytes", help="bytes").set(4096)
    reg.gauge("kv_bytes", labels={"dtype": "int8"}).set(1024)
    reg.gauge("occupancy_pct").set(37.5)
    reg.gauge("pending", fn=lambda: 3)
    reg.gauge("broken", fn=lambda: 1 / 0)
    reg.gauge("huge").set(1e20)
    reg.gauge("neg").set(-2.25)


def _exp_histograms(reg):
    h = reg.histogram("latency_ms", buckets=(1, 2.5, 5, 10),
                      help="request latency\nin ms")
    for v, ex in ((0.5, None), (2.0, "aaaa"), (2.4, "bbbb"), (7.0, None),
                  (100.0, "cccc")):
        h.observe(v, exemplar=ex)
    reg.histogram("default_buckets").observe(0.2)


def _exp_escaping(reg):
    reg.gauge("esc", labels={"path": 'a"b\\c\nd', "z-key": "v"}).set(1)
    reg.counter("esc_total", help='help with \\ and\nnewline').inc()


class _Group:
    def get_name_value(self):
        return [("qps", 12.5), ("latency-ms p50", 3), ("nan", float("nan"))]


def _exp_groups(reg):
    g1, g2 = _Group(), _Group()
    assert reg.register_group("serving", g1) == 0
    assert reg.register_group("serving", g2) == 1
    reg.gauge("after_groups").set(1)
    return g1, g2


@pytest.mark.parametrize("scenario", [_exp_counters, _exp_gauges,
                                      _exp_histograms, _exp_escaping,
                                      _exp_groups])
def test_exposition_is_the_reference_byte_for_byte(scenario, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    texts, pairs, keep = [], [], []
    for metrics in (jmetrics, tmetrics):
        reg = metrics.Registry()
        keep.append(scenario(reg))
        texts.append(reg.exposition())
        pairs.append(repr(reg.get_name_value()))
        for line in texts[-1].splitlines():
            assert PROM_LINE.match(line), line
    assert texts[0] == texts[1]
    assert pairs[0] == pairs[1]


def test_registry_type_conflicts_and_group_pruning_match_the_reference():
    for metrics in (jmetrics, tmetrics):
        reg = metrics.Registry()
        reg.counter("x_total")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x_total")
        g = _Group()
        sid = reg.register_group("grp", g)
        assert 'grp_qps{sid="%d"} 12.5' % sid in reg.exposition()
        del g
        import gc
        gc.collect()
        assert "grp_qps" not in reg.exposition()
        assert reg._groups == []
        reg.reset()
        assert reg.exposition() == "\n"
    assert tmetrics.CONTENT_TYPE_LATEST == jmetrics.CONTENT_TYPE_LATEST


def test_serving_metrics_are_adopted_and_pruned_as_the_reference():
    names = []
    for smetrics, tel in ((jsmetrics, jtel), (tsmetrics, ttel)):
        m = smetrics.ServingMetrics(queue_depth_fn=lambda: 2)
        m.record_submit(3)
        m.record_batch(3, 4, [1.0, 2.0, 3.0])
        m.record_error("queue_full")
        m.observe_latency(7.0, trace_id="f" * 32)
        text = tel.registry.exposition()
        assert 'serving_queue_depth{sid="%d"} 2' % m.sid in text
        assert 'serving_batches{sid="%d"} 1' % m.sid in text
        names.append((m.get()[0], m.bucket_latency(4, 50),
                      m.request_size_histogram(), m.error_counts(),
                      smetrics.latency_histogram().buckets,
                      smetrics.latency_histogram().snapshot()[2]))
        del m
        import gc
        gc.collect()
        assert "serving_queue_depth" not in tel.registry.exposition()
    assert names[0] == names[1]
    assert tsmetrics.LATENCY_BUCKETS_MS == jsmetrics.LATENCY_BUCKETS_MS


# --- trace context -----------------------------------------------------------

VALID = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
MALFORMED = [
    None, "", "garbage",
    "00-abc-def-01",                                   # short fields
    VALID + "-extra",                                  # 5 segments
    "ff-" + VALID[3:],                                 # version ff
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",         # zero trace
    "0af7651916cd43dd8448eb211c80319c".join(["00-", "-" + "0" * 16
                                             + "-01"]),  # zero span
    VALID.replace("0af7", "zzzz"),                     # non-hex
]


@pytest.mark.parametrize("header", MALFORMED)
def test_malformed_traceparent_is_ignored_as_the_reference(header):
    assert jctx.parse_traceparent(header) is None
    assert tctx.parse_traceparent(header) is None


@pytest.mark.parametrize("header", [VALID, VALID.replace("-01", "-00"),
                                    "  " + VALID.upper() + " "])
def test_traceparent_parse_and_round_trip_match_the_reference(header):
    got = []
    for ctx in (jctx, tctx):
        c = ctx.parse_traceparent(header, request_id="r7")
        back = ctx.parse_traceparent(ctx.to_traceparent(c))
        got.append((c.trace_id, c.parent_id, c.request_id, c.sampled,
                    len(c.span_id), c.span_id != c.parent_id,
                    back.trace_id, back.parent_id == c.span_id,
                    ctx.to_traceparent(c)[:36], c.stamps().keys()))
    assert got[0] == got[1]


def test_mint_child_stamps_and_headers_match_the_reference():
    got = []
    for ctx in (jctx, tctx):
        root = ctx.mint(request_id="req1")
        c1 = root.child()
        c2 = c1.child()
        ids = {ctx.mint_span_id() for _ in range(1000)}
        hdr = ctx.from_headers({"traceparent": VALID, "x-request-id": "abc"})
        fresh = ctx.from_headers({})
        got.append((
            c1.trace_id == c2.trace_id == root.trace_id,
            c1.parent_id == root.span_id, c2.parent_id == c1.span_id,
            c2.request_id,
            {k: _shape(v) for k, v in c1.stamps().items()},
            "parent_id" in root.stamps(), len(ids),
            {len(i) for i in ids}, (hdr.trace_id, hdr.request_id),
            (len(fresh.trace_id), len(fresh.request_id)),
            len(ctx.mint_request_id()), repr(root)[:23]))
    assert got[0] == got[1]


def test_use_is_reentrant_and_thread_local_as_the_reference():
    for ctx in (jctx, tctx):
        assert ctx.current_context() is None
        a, b = ctx.mint(), ctx.mint()
        with ctx.use(a):
            assert ctx.current_context() is a
            with ctx.use(b):
                assert ctx.current_context() is b
            assert ctx.current_context() is a
        assert ctx.current_context() is None
        seen = []
        with ctx.use(a):
            t = threading.Thread(target=lambda: seen.append(
                ctx.current_context()))
            t.start()
            t.join(10)
        assert seen == [None]
        ctx.set_current(b)
        assert ctx.current_context() is b
        ctx.clear_current()
        assert ctx.current_context() is None


# --- flight recorder ---------------------------------------------------------

def _tree_shape(tree):
    """A flight tree without clocks, thread ids and random ids."""
    if tree is None:
        return None

    def node(n):
        return (n["ph"], n["name"], n["domain"], _args(n["args"]),
                [node(c) for c in n["children"]])

    out = {k: _shape(v) for k, v in tree.items() if k != "spans"}
    out["spans"] = [node(n) for n in tree["spans"]]
    return out


def _flight_tee(tel, ctx, flight):
    tel.enable_spans("serving")
    root = ctx.mint(request_id="r1")

    def worker():
        with tel.span("serving.dispatch", domain="serving",
                      **root.child().stamps()):
            pass

    child = root.child()
    with tel.span("serving.queued", domain="serving", **child.stamps()):
        with tel.span("serving.forward", domain="serving",
                      **child.child().stamps()):
            pass
    with tel.span("serving.form_batch", domain="serving"):
        pass                                   # unstamped: not teed
    t = threading.Thread(target=worker)
    t.start()
    t.join(10)
    live = flight.request_tree(root.trace_id)
    flight.request_end(root, ok=True, latency_ms=4.2, request_id="r1")
    done = flight.request_tree("r1")
    return (_tree_shape(live), _tree_shape(done),
            flight.summary()["live_traces"],
            [r["request_id"] for r in flight.summary()["ring"]])


def _flight_fan_out(tel, ctx, flight):
    tel.enable_spans("serving")
    a, b = ctx.mint(), ctx.mint()
    with tel.span("decode.step", domain="serving",
                  trace_ids=[a.trace_id, b.trace_id],
                  span_id=ctx.mint_span_id()):
        pass
    return [_tree_shape(flight.request_tree(c.trace_id)) for c in (a, b)]


def _flight_anomaly(tel, ctx, flight):
    tel.enable_spans("serving")
    victim = ctx.mint(request_id="victim")
    tel.registry.counter("requests_total").inc()
    with tel.span("serving.queued", domain="serving",
                  **victim.child().stamps()):
        pass
    path = flight.on_anomaly("deadline_miss", victim, request_id="victim",
                             latency_ms=12.0)
    assert os.path.basename(path).startswith(
        "flight_deadline_miss_%d_" % os.getpid())
    with open(path) as f:
        bundle = json.load(f)
    assert "MXNET_FLIGHT_DIR" in bundle["config"]
    assert "# TYPE" in bundle["metrics"]
    assert path in flight.summary()["bundles"]
    expo = tel.registry.exposition()
    return ({k: _shape(v) for k, v in bundle.items()
             if k not in ("ts", "pid", "victim", "recent_requests",
                          "metrics", "config")},
            _tree_shape(bundle["victim"]),
            'flight_bundles_total{trigger="deadline_miss"} 1' in expo)


@pytest.mark.parametrize("scenario", [_flight_tee, _flight_fan_out,
                                      _flight_anomaly])
def test_flight_recorder_matches_the_reference(scenario):
    got = [scenario(tel, ctx, flight) for tel, ctx, flight, _m, _t in
           (JAX, TORCH)]
    assert got[0] == got[1]


@pytest.mark.parametrize("cap", [0, 2, 5])
def test_bundle_cap_bounds_the_disk_as_the_reference(cap, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_MAX_BUNDLES", str(cap))
    got = []
    for tel, _ctx, flight, _m, _t in (JAX, TORCH):
        paths = [flight.on_anomaly("shed", message="m%d" % i)
                 for i in range(4)]
        expo = tel.registry.exposition()
        got.append(([p is not None for p in paths],
                     len(flight.summary()["triggers"]),
                     [ln for ln in expo.splitlines()
                      if ln.startswith("flight_bundles")]))
    assert got[0] == got[1]
    assert got[1][0] == [i < cap for i in range(4)]


@pytest.mark.parametrize("threshold,latencies,fires", [
    ("50", (10.0, 80.0), [False, True]), ("0", (10.0, 1e6), [False, False]),
    ("", (99.0,), [False])])
def test_slow_request_threshold_matches_the_reference(threshold, latencies,
                                                      fires, monkeypatch):
    monkeypatch.setenv("MXNET_SLOW_REQUEST_MS", threshold)
    got = []
    for _tel, ctx, flight, _m, _t in (JAX, TORCH):
        seen = []
        for lat in latencies:
            before = len(flight.summary()["bundles"])
            flight.request_end(ctx.mint(), ok=True, latency_ms=lat)
            seen.append(len(flight.summary()["bundles"]) > before)
        flight.request_end(ctx.mint(), ok=False, latency_ms=1e9)
        got.append(seen)
    assert got[0] == got[1] == fires


def test_ring_bound_and_disabled_recorder_match_the_reference(monkeypatch):
    got = []
    for _tel, ctx, flight, _m, _t in (JAX, TORCH):
        monkeypatch.setenv("MXNET_FLIGHT_RING", "4")
        flight.reset()
        for i in range(10):
            flight.request_end(ctx.mint(request_id="r%d" % i), ok=True,
                               latency_ms=1.0)
        ring = [r["request_id"] for r in flight.summary()["ring"]]
        aged = flight.request_tree("r0") is None
        kept = flight.request_tree("r9") is not None
        monkeypatch.setenv("MXNET_FLIGHT_RECORDER", "0")
        flight.reset()
        off = (flight.enabled(), flight.on_anomaly("shed"))
        flight.request_end(ctx.mint(), ok=True, latency_ms=1.0)
        got.append((ring, aged, kept, off, flight.summary()["ring"]))
        monkeypatch.delenv("MXNET_FLIGHT_RECORDER")
        monkeypatch.delenv("MXNET_FLIGHT_RING")
        flight.reset()
    assert got[0] == got[1]
    assert got[1][0] == ["r6", "r7", "r8", "r9"]


# --- the port's profiler, engine and quantized-bytes gauge -------------------

def test_dump_profile_always_writes_even_with_zero_events(tmp_path):
    tprofiler.profiler_set_config(filename=str(tmp_path / "empty.json"))
    path = tprofiler.dump_profile()
    assert path == str(tmp_path / "empty.json")
    with open(path) as f:
        data = json.load(f)
    assert data == {"traceEvents": [], "displayTimeUnit": "ms"}


def test_dump_profile_holds_host_spans_and_the_cpu_device_half(tmp_path):
    """One window: the host spans (engine ops, a marked window) and the
    torch.profiler CPU activity (a TraceAnnotation region and the aten op
    inside it) in one file, the device events moved onto the host clock;
    spans are off again after the window, and a second dump holds only
    newer events."""
    tprofiler.profiler_set_config(filename=str(tmp_path / "p.json"))
    assert not ttel.enabled("engine")
    t0 = time.monotonic_ns() / 1000.0
    tprofiler.profiler_set_state("run")
    assert ttel.enabled("engine") and ttel.enabled("anything")
    tengine.push(lambda: None, name="traced_op")
    tengine.wait_for_all()
    with tprofiler.TraceAnnotation("annotated", step=3):
        torch.ones(8, 8).sum()
    tprofiler.profiler_set_state("stop")
    t1 = time.monotonic_ns() / 1000.0
    assert not ttel.enabled("engine")
    path = tprofiler.dump_profile()
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    names = {(e.get("cat"), e["name"]) for e in evs}
    assert ("engine", "traced_op") in names
    assert ("engine", "engine.wait_for_all") in names
    assert ("profiler", "mxnet_profile") in names
    (region,) = [e for e in evs if e["name"] == "annotated"]
    assert region["cat"] == "user_annotation"
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::sum"
               for e in evs)
    # the device half sits inside the window on the host spans' clock
    assert t0 - 1e3 <= region["ts"] <= t1 + 1e3
    with open(tprofiler.dump_profile()) as f:
        assert json.load(f)["traceEvents"] == []


def test_profiler_restores_the_domains_it_found(tmp_path):
    tprofiler.profiler_set_config(filename=str(tmp_path / "d.json"))
    ttel.enable_spans("serving")
    tprofiler.profiler_set_state("run")
    assert ttel.enabled_domains() == "all"
    tprofiler.profiler_set_state("stop")
    assert ttel.enabled_domains() == "serving"
    tprofiler.dump_profile()


def test_engine_spans_carry_the_queue_wait_and_the_variables():
    ttel.enable_spans("engine")
    v = tengine.new_variable()
    w = tengine.new_variable()
    tengine.push(lambda: None, const_vars=[v], mutable_vars=[w],
                 name="my_op")
    tengine.fence([w]).wait()
    tengine.wait_for_all()
    evs = {e[1]: e for e in ttel.drain_events()}
    op = evs["my_op"]
    assert op[2] == "engine" and op[5]["queue_us"] >= 0
    assert op[5]["const_vars"] == [v] and op[5]["mutable_vars"] == [w]
    assert evs["engine.fence.wait"][5] == {"n_vars": 1}
    assert "fence" in evs and "engine.wait_for_all" in evs
    ttel.disable_spans()
    tengine.push(lambda: None, name="quiet_op")
    tengine.wait_for_all()
    assert ttel.drain_events() == []


def test_engine_pending_gauge_never_creates_an_engine(monkeypatch):
    """The gauge the engine registers when imported reads 0 without an
    engine and creates none; with one, it reads the ops in flight."""
    gauge = PROCESS_REGISTRY[1]._metrics["engine_pending_ops"]
    monkeypatch.setattr(tengine, "_engine", None)
    assert gauge.value == 0 and tengine._engine is None
    monkeypatch.undo()
    release = threading.Event()
    # both ops write one variable, so "queued" waits behind "held" on any
    # engine (the native ThreadedEngine runs independent ops at once)
    var = tengine.new_variable()
    tengine.push(lambda: release.wait(10), mutable_vars=[var], name="held")
    tengine.push(lambda: None, mutable_vars=[var], name="queued")
    try:
        assert gauge.value == 2
    finally:
        release.set()
    tengine.delete_variable(var)
    tengine.wait_for_all()
    assert gauge.value == 0
    assert "engine_pending_ops 0" in PROCESS_REGISTRY[1].exposition()


def test_quant_params_bytes_gauge_counts_as_the_reference():
    from mxnet_tpu import quant as jquant
    from mxnet_tpu_torch import quant as tquant

    w = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    grew = []
    for quant, tel, q in ((jquant, jtel, lambda: jquant.quantize_params(
            {"w": w, "b": w[0]}, {"w": 0}, "int8")),
            (tquant, ttel, lambda: tquant.quantize_params(
                {"w": torch.from_numpy(w), "b": torch.from_numpy(w[0])},
                {"w": 0}, "int8"))):
        before = quant.quant_params_bytes().get("int8", 0)
        q()
        after = quant.quant_params_bytes()["int8"]
        gauge = tel.registry.gauge("quant_params_bytes",
                                   labels={"dtype": "int8"})
        assert gauge.value == after
        grew.append(after - before)
    assert grew[0] == grew[1] > 0
