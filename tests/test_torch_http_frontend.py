"""mxnet_tpu_torch.serving.frontend: the HTTP / SSE front door, on the CPU.

One counterpart of every test of ``tests/test_http_frontend.py`` on the
port's frontend over servers with ``devices=["cpu"]``: the routes, request
id echo and structured errors, the b64 raw-tensor form, SSE framing equal
to the in-process ``submit_stream`` (vanilla and speculative, self draft),
admission (batch-class 429 shed, 503 at ``max_inflight`` and while
draining), the ``timeout-ms`` header into the former's reject-early
check, interactive-before-batch order, the SIGTERM drain (the previous
handler restored), the exposition's framing and strict conformance, and
request tracing through the flight recorder. Then what the port adds: the
same script of requests through the JAX package's frontend and the port's
on the same weights, a client that disconnects mid-stream freeing its
slot, and host arrays on the wire.

Tolerances: predict outputs within rtol 1e-5 / atol 1e-6 of the
in-process forward and of the JAX package's (f32 on both; a product summed
in another order moves the last bits); greedy token ids equal. Counters
are read as differences (the telemetry registry is process-wide). Every
frontend binds 127.0.0.1 on port 0 and is stopped by ``with`` or
``finally``; every ``http.client`` call has a timeout.
"""
import base64
import http.client
import json
import os
import re
import signal
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.serving import frontend as jfrontend
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.serving.batcher import BatchFormer, Request
from mxnet_tpu_torch.serving.frontend import (AdmissionController, iter_sse,
                                              routes, sse_event)
from test_http_frontend import TID, TP, _assert_prometheus_conformant, \
    _walk_spans

V, D, L, F, H, HKV = 32, 16, 2, 32, 4, 2
TOL = {"rtol": 1e-5, "atol": 1e-6}
WAIT = 60.0     # seconds: the longest any one client call may block


# --- fixtures ---------------------------------------------------------------

def _mlp_symbol(pkg=mt):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    sym = _mlp_symbol()
    shapes, _, _ = sym.infer_shape(data=(1, 10))
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _lm_params(seed=0):
    rng = np.random.RandomState(seed)
    dkv = D // H * HKV
    p = {"embed_weight": rng.randn(V, D).astype(np.float32) * 0.3}
    for i in range(L):
        pre = "layer%d" % i
        p.update({
            pre + "_ln1_gamma": np.ones(D, np.float32),
            pre + "_ln1_beta": np.zeros(D, np.float32),
            pre + "_q_weight": rng.randn(D, D).astype(np.float32) * 0.2,
            pre + "_k_weight": rng.randn(dkv, D).astype(np.float32) * 0.2,
            pre + "_v_weight": rng.randn(dkv, D).astype(np.float32) * 0.2,
            pre + "_o_weight": rng.randn(D, D).astype(np.float32) * 0.2,
            pre + "_ln2_gamma": np.ones(D, np.float32),
            pre + "_ln2_beta": np.zeros(D, np.float32),
            pre + "_ffn1_weight": rng.randn(F, D).astype(np.float32) * 0.2,
            pre + "_ffn1_bias": np.zeros(F, np.float32),
            pre + "_ffn2_weight": rng.randn(D, F).astype(np.float32) * 0.2,
            pre + "_ffn2_bias": np.zeros(D, np.float32)})
    p.update({"lnf_gamma": np.ones(D, np.float32),
              "lnf_beta": np.zeros(D, np.float32),
              "pred_weight": rng.randn(V, D).astype(np.float32) * 0.2,
              "pred_bias": np.zeros(V, np.float32)})
    return p


def _port_kw(pkg, replicas=1):
    return {"devices": ["cpu"] * replicas} if pkg is mt else {}


def _mlp_frontend(buckets=(1, 2, 4), max_delay_ms=5.0, queue_depth=64,
                  timeout_ms=5000.0, fe_kw=None, pkg=mt):
    srv = pkg.serving.InferenceServer(
        _mlp_symbol(pkg), _mlp_params(), {"data": (10,)},
        config=pkg.serving.ServingConfig(
            buckets=buckets, max_delay_ms=max_delay_ms,
            queue_depth=queue_depth, timeout_ms=timeout_ms, replicas=1),
        **_port_kw(pkg))
    fe_mod = mt.serving.frontend if pkg is mt else jfrontend
    fe = fe_mod.HttpFrontend(srv, fe_mod.FrontendConfig(port=0,
                                                        **(fe_kw or {})))
    return fe, srv


def _lm_frontend(spec=False, max_new_tokens=8, slots=2, max_context=32,
                 pkg=mt):
    decode = pkg.serving.GenerateConfig(
        num_heads=H, num_kv_heads=HKV, slots=slots, max_context=max_context,
        prefill_buckets=(4, 8), max_new_tokens=max_new_tokens,
        queue_depth=16, paged=False, eos_id=None,
        spec=spec, spec_tokens=3, spec_draft="self",
        kv_dtype="f32", quant_weights="", capture=False)
    sym = pkg.models.get_symbol(
        "transformer-lm", num_classes=V, num_layers=L, num_heads=H,
        model_dim=D, ffn_dim=F, num_kv_heads=HKV)
    srv = pkg.serving.InferenceServer(
        sym, _lm_params(), {"data": (8,), "softmax_label": (8,)},
        config=pkg.serving.ServingConfig(buckets=(1, 2), max_delay_ms=5.0,
                                         timeout_ms=10000.0, replicas=1),
        decode=decode, **_port_kw(pkg))
    fe_mod = mt.serving.frontend if pkg is mt else jfrontend
    fe = fe_mod.HttpFrontend(srv, fe_mod.FrontendConfig(port=0))
    return fe, srv


# --- tiny stdlib HTTP clients ------------------------------------------------

def _req(port, method, path, body=None, headers=None, timeout=WAIT,
         raw_body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = raw_body if raw_body is not None else (
            None if body is None else json.dumps(body))
        conn.request(method, path, data,
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        payload = json.loads(raw) if raw and \
            hdrs.get("content-type", "").startswith("application/json") \
            else raw
        return r.status, hdrs, payload
    finally:
        conn.close()


def _sse(port, body, headers=None, timeout=WAIT, on_event=None):
    """POST /v1/generate and parse the SSE stream fully."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        if r.status != 200:
            return r.status, hdrs, json.loads(r.read())
        assert hdrs["content-type"].startswith("text/event-stream")
        events = []
        for ev in iter_sse(r):
            events.append(ev)
            if on_event is not None:
                on_event(ev)
        return r.status, hdrs, events
    finally:
        conn.close()


def _sse_tokens(events):
    toks = [d["token"] for e, d in events if e == "token"]
    assert [d["index"] for e, d in events if e == "token"] \
        == list(range(len(toks)))
    return toks


def _counter(name):
    return dict(telemetry.registry.get_name_value()).get(name, 0)


# --- (a) routes --------------------------------------------------------------

def test_health_ready_metrics_and_404():
    fe, srv = _mlp_frontend()
    with fe:
        port = fe.port
        st, _, body = _req(port, "GET", "/healthz")
        assert st == 200 and body["status"] == "ok"
        deadline = time.monotonic() + WAIT
        while True:
            st, _, body = _req(port, "GET", "/readyz")
            if st == 200:
                break
            assert body["status"] == "warming"
            assert time.monotonic() < deadline, body
            time.sleep(0.01)
        assert srv.ready()
        st, hdrs, raw = _req(port, "GET", "/metrics")
        assert st == 200
        assert hdrs["content-type"] == telemetry.CONTENT_TYPE_LATEST
        text = raw.decode("utf-8")
        assert "# HELP" in text and "# TYPE" in text
        st, hdrs, body = _req(port, "GET", "/nope",
                              headers={"x-request-id": "rid-404"})
        assert st == 404 and body["error"]["code"] == "not_found"
        assert hdrs["x-request-id"] == "rid-404"
        st, _, body = _req(port, "POST", "/v1/nope", body={})
        assert st == 404


def test_predict_roundtrip_and_request_id_echo():
    fe, srv = _mlp_frontend()
    x = np.random.RandomState(3).uniform(-1, 1, (1, 10)).astype(np.float32)
    with fe:
        want = srv.predict(data=x)
        st, hdrs, body = _req(fe.port, "POST", "/v1/predict",
                              body={"inputs": {"data": x.tolist()}},
                              headers={"x-request-id": "req-42"})
        assert st == 200
        assert body["request_id"] == "req-42"
        assert hdrs["x-request-id"] == "req-42"
        got = np.asarray(body["outputs"][0], np.float32)
        np.testing.assert_allclose(got, want[0], **TOL)
        st, hdrs, body = _req(fe.port, "POST", "/v1/predict",
                              body={"inputs": {"data": x.tolist()}})
        assert st == 200 and body["request_id"] == hdrs["x-request-id"]


def test_predict_b64_raw_tensor_roundtrip():
    fe, srv = _mlp_frontend()
    x = np.random.RandomState(11).uniform(-1, 1, (3, 10)).astype(np.float32)
    b64_in = {"b64": base64.b64encode(np.ascontiguousarray(x)).decode(),
              "shape": [3, 10], "dtype": "float32"}
    with fe:
        want = srv.predict(data=x)
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"inputs": {"data": b64_in}})
        assert st == 200
        np.testing.assert_allclose(
            np.asarray(body["outputs"][0], np.float32), want[0], **TOL)
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"encoding": "b64",
                                 "inputs": {"data": b64_in}})
        assert st == 200
        out = body["outputs"][0]
        got = np.frombuffer(base64.b64decode(out["b64"]),
                            dtype=np.dtype(out["dtype"])).reshape(
                                out["shape"])
        np.testing.assert_allclose(got, want[0], **TOL)
        for bad in ({"b64": "!!!not-base64!!!", "shape": [3, 10]},
                    {"b64": b64_in["b64"], "shape": [7, 10]},
                    {"shape": [3, 10]}):
            st, _, body = _req(fe.port, "POST", "/v1/predict",
                               body={"inputs": {"data": bad}})
            assert st == 400, bad
            assert body["error"]["code"] == "bad_request"


def test_bad_requests_400():
    fe, _ = _mlp_frontend()
    with fe:
        port = fe.port
        st, _, body = _req(port, "POST", "/v1/predict", raw_body=b"{not json")
        assert st == 400 and body["error"]["code"] == "bad_request"
        st, _, body = _req(port, "POST", "/v1/predict", body={"x": 1})
        assert st == 400 and body["error"]["code"] == "bad_request"
        st, _, body = _req(port, "POST", "/v1/predict",
                           body={"inputs": {"data": [[0.0] * 10]}},
                           headers={"x-priority": "turbo"})
        assert st == 400 and "x-priority" in body["error"]["message"]
        st, _, body = _req(port, "POST", "/v1/generate", body={})
        assert st == 400


# --- (b) SSE identical to in-process ----------------------------------------

@pytest.mark.parametrize("spec", [False, True],
                         ids=["vanilla", "spec_decode"])
def test_sse_generate_token_identical_to_inprocess(spec):
    fe, srv = _lm_frontend(spec=spec, max_new_tokens=6)
    prompt = [3, 7, 1]
    with fe:
        want = srv.generate(prompt, max_new_tokens=6)
        st, hdrs, events = _sse(fe.port,
                                {"prompt": prompt, "max_new_tokens": 6},
                                headers={"x-request-id": "sse-1"})
        assert st == 200 and hdrs["x-request-id"] == "sse-1"
        assert _sse_tokens(events) == want
        kinds = [e for e, _ in events]
        assert kinds[-1] == "done" and "error" not in kinds
        done = events[-1][1]
        assert done["request_id"] == "sse-1"
        assert done["tokens"] == len(want)
        assert done["finish_reason"] in ("max_tokens", "eos")
        st, _, body = _req(fe.port, "POST", "/v1/generate",
                           body={"prompt": prompt, "max_new_tokens": 6,
                                 "stream": False})
        assert st == 200 and body["tokens"] == want
        # Accept: application/json asks for the one-body form too
        st, _, body = _req(fe.port, "POST", "/v1/generate",
                           body={"prompt": prompt, "max_new_tokens": 6},
                           headers={"Accept": "application/json"})
        assert st == 200 and body["tokens"] == want
        if spec:
            assert srv.decode_stats()["drafted_tokens"] > 0


def test_request_id_rides_token_stream():
    fe, srv = _lm_frontend(max_new_tokens=4)
    with fe:
        stream = srv.submit_stream([5, 2, 9], max_new_tokens=4,
                                   request_id="corr-7")
        assert stream.request_id == "corr-7"
        assert len(stream.tokens(WAIT)) == 4


# --- (c) admission control ---------------------------------------------------

def test_batch_class_sheds_429_with_retry_after():
    fe, srv = _mlp_frontend(buckets=(8,), max_delay_ms=400.0,
                            queue_depth=8, fe_kw={"shed_pct": 25.0})
    x = np.zeros((1, 10), np.float32)
    shed0, req0 = _counter("http_shed_total"), _counter("http_requests_total")
    with fe:
        parked = [srv.submit(data=x) for _ in range(4)]
        st, hdrs, body = _req(fe.port, "POST", "/v1/predict",
                              body={"inputs": {"data": x.tolist()}},
                              headers={"x-priority": "batch"})
        assert st == 429, body
        assert body["error"]["code"] == "shed"
        assert int(hdrs["retry-after"]) >= 1
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"inputs": {"data": x.tolist()}})
        assert st == 200
        for r in parked:
            r.get(WAIT)
    assert _counter("http_shed_total") - shed0 == 1
    assert _counter("http_requests_total") - req0 == 1


class _FakeFormer:
    queue_depth = 8
    parallelism = 1

    def depth(self):
        return 0

    def dispatch_ewma_s(self):
        return 0.0


class _FakeServer:
    _former = _FakeFormer()


def test_admission_unit_inflight_cap_and_draining():
    adm = AdmissionController(_FakeServer(), max_inflight=1, shed_pct=80.0)
    d, n = adm.decide(0)
    assert d is None and n == 1
    d2, _ = adm.decide(0)
    assert d2 is not None and d2.status == 503 and d2.code == "overloaded"
    assert d2.retry_after_s >= 1
    adm.exit()
    assert adm.inflight() == 0
    adm.set_draining()
    d3, _ = adm.decide(0)
    assert d3 is not None and d3.status == 503 \
        and d3.code == "shutting_down"


def test_admission_backlog_counts_router_inflight_and_retry_after():
    """The shed signal is queued requests plus dispatched batches, and
    Retry-After is that backlog x the dispatch EWMA over the parallelism,
    floored at 1 s; the http_inflight gauge follows the newest live
    controller."""
    class Former(_FakeFormer):
        parallelism = 2

        def depth(self):
            return 1

        def dispatch_ewma_s(self):
            return 1.5

    class Server:
        _former = Former()

        def router_inflight(self):
            return [2, 3]

    adm = AdmissionController(Server(), max_inflight=4, shed_pct=50.0)
    assert adm._backlog() == 6
    d, _ = adm.decide(1)                 # 6 >= 50% of 8: shed
    assert d.status == 429 and d.code == "shed"
    assert d.retry_after_s == 5          # ceil(6 * 1.5 / 2)
    assert adm.inflight() == 0
    d, _ = adm.decide(0)                 # interactive is not shed
    assert d is None
    gauge = telemetry.registry.gauge("http_inflight")
    assert gauge.value == 1
    newer = AdmissionController(Server(), max_inflight=4, shed_pct=50.0)
    newer.enter()
    newer.enter()
    assert gauge.value == 2              # re-pointed at the newest
    del newer
    assert gauge.value == 0              # a dead controller reads 0
    adm.exit()


# --- (d) deadline header propagation -----------------------------------------

def test_timeout_ms_header_feeds_reject_early():
    fe, srv = _mlp_frontend(buckets=(1, 2, 4), max_delay_ms=300.0,
                            queue_depth=64)
    x = np.zeros((1, 10), np.float32)
    with fe:
        for s in (0.05, 0.05, 0.05):
            srv._former.note_dispatch(s)
        parked = [srv.submit(data=x) for _ in range(2)]
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"inputs": {"data": x.tolist()}},
                           headers={"timeout-ms": "10"})
        assert st == 429, body
        assert body["error"]["code"] == "deadline_exceeded"
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"inputs": {"data": x.tolist()}},
                           headers={"timeout-ms": "10000"})
        assert st == 200
        for r in parked:
            r.get(WAIT)
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"inputs": {"data": x.tolist()}},
                           headers={"timeout-ms": "bogus"})
        assert st == 400


def test_former_reject_early_unit():
    f = BatchFormer(max_batch=4, max_delay_ms=5000.0, queue_depth=64)
    for _ in range(3):
        f.note_dispatch(0.05)
    f.submit(Request({}, 4, None))
    now = time.monotonic()
    with pytest.raises(ServingError) as ei:
        f.submit(Request({}, 1, now + 0.001))
    assert ei.value.code == "deadline_exceeded"
    assert f.depth() == 1
    f.submit(Request({}, 1, now + 30.0))
    assert f.depth() == 2
    cold = BatchFormer(max_batch=4, max_delay_ms=5000.0, queue_depth=64)
    cold.submit(Request({}, 4, None))
    cold.submit(Request({}, 1, time.monotonic() + 0.001))
    assert cold.depth() == 2
    f.close()
    cold.close()


# --- (e) priority ordering ---------------------------------------------------

def test_interactive_dispatches_before_batch_class():
    f = BatchFormer(max_batch=2, max_delay_ms=5.0, queue_depth=64)
    b1 = Request({}, 1, None, priority=serving.PRIORITY_BATCH)
    b2 = Request({}, 1, None, priority=serving.PRIORITY_BATCH)
    i1 = Request({}, 1, None, priority=serving.PRIORITY_INTERACTIVE)
    i2 = Request({}, 1, None, priority=serving.PRIORITY_INTERACTIVE)
    for r in (b1, b2, i1, i2):
        f.submit(r)
    assert f.next_batch() == [i1, i2]
    assert f.next_batch() == [b1, b2]
    f.close()
    with pytest.raises(ServingError):
        Request({}, 1, None, priority=7)


# --- (f) SIGTERM drain -------------------------------------------------------

def test_sigterm_drain_completes_streams_zero_drops():
    fe, srv = _lm_frontend(max_new_tokens=12)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        fe.start(wait_ready=True)
        fe.install_signal_handlers()
        first_token = threading.Event()
        result = {}

        def client():
            try:
                result["resp"] = _sse(
                    fe.port, {"prompt": [3, 7, 1], "max_new_tokens": 12},
                    on_event=lambda ev: first_token.set())
            except BaseException as e:  # noqa: BLE001
                result["error"] = e

        t = threading.Thread(target=client, daemon=True)
        t.start()
        assert first_token.wait(WAIT), "stream never produced a token"
        os.kill(os.getpid(), signal.SIGTERM)
        t.join(WAIT)
        assert not t.is_alive() and "error" not in result, result
        st, _, events = result["resp"]
        assert st == 200
        kinds = [e for e, _ in events]
        assert kinds[-1] == "done", kinds
        assert "error" not in kinds
        assert len(_sse_tokens(events)) == 12
        assert fe._stopped.wait(WAIT)
        try:
            st, _, body = _req(fe.port, "POST", "/v1/predict",
                               body={"inputs": {"data": [[0.0] * 10]}},
                               timeout=5)
            assert st == 503
        except OSError:
            pass                                # listener already closed
    finally:
        signal.signal(signal.SIGTERM, prev)
        fe.stop()
    assert signal.getsignal(signal.SIGTERM) is prev


# --- exposition framing ------------------------------------------------------

def test_exposition_help_and_type_for_every_family():
    reg = telemetry.Registry()
    reg.counter("helped_total", help="a documented counter").inc(2)
    reg.counter("bare_total").inc()
    reg.gauge("g_plain").set(1.5)
    reg.gauge("g_lab", labels={"dtype": "int8"}).set(3)
    reg.gauge("g_lab", labels={"dtype": "fp8"}).set(4)
    reg.histogram("h_ms", buckets=(1, 10)).observe(5)

    class _Grp:
        def get_name_value(self):
            return [("qps", 7.0)]

    grp = _Grp()
    reg.register_group("srv", grp)
    text = reg.exposition()
    lines = text.splitlines()
    helped = {ln.split()[2] for ln in lines if ln.startswith("# HELP")}
    typed = {ln.split()[2] for ln in lines if ln.startswith("# TYPE")}
    families = set()
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        fam = ln.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if fam.endswith(suffix) and fam[: -len(suffix)] in typed:
                fam = fam[: -len(suffix)]
                break
        families.add(fam)
    assert families, text
    for fam in families:
        assert fam in typed, (fam, text)
        assert fam in helped, (fam, text)
    assert sum(1 for ln in lines if ln.startswith("# TYPE g_lab ")) == 1
    assert "# HELP bare_total bare_total" in text
    assert telemetry.CONTENT_TYPE_LATEST.startswith("text/plain")


# --- request tracing + flight recorder ---------------------------------------

@pytest.fixture()
def traced(tmp_path, monkeypatch):
    """Spans on for the serving domain + an isolated flight dir."""
    from mxnet_tpu_torch.telemetry import flight
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "flight"))
    prev = telemetry.enabled_domains()
    telemetry.enable_spans("serving")
    flight.reset()
    yield flight
    if prev:
        telemetry.enable_spans(prev)
    else:
        telemetry.disable_spans()
    flight.reset()


def test_traceparent_assembles_one_tree_with_exemplar(traced):
    fe, _ = _lm_frontend(max_new_tokens=4)
    with fe:
        st, hdrs, events = _sse(
            fe.port, {"prompt": [3, 7, 1], "max_new_tokens": 4},
            headers={"traceparent": TP, "x-request-id": "tr-1"})
        assert st == 200
        assert hdrs["x-trace-id"] == TID
        assert hdrs["traceparent"].startswith("00-%s-" % TID)
        assert "00f067aa0ba902b7" not in hdrs["traceparent"]
        assert events[-1][0] == "done"
        deadline = time.monotonic() + WAIT
        while True:
            st, _, tree = _req(fe.port, "GET", "/debug/requests/tr-1")
            if st == 200 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert st == 200, tree
        assert tree["trace_id"] == TID and tree["ok"] is True
        names, tids = set(), set()
        _walk_spans(tree["spans"], lambda s: (names.add(s["name"]),
                                              tids.add(s["tid"])))
        assert {"serving.queued", "serving.dispatch",
                "decode.step"} <= names, names
        assert len(tids) >= 2
        st, _, by_trace = _req(fe.port, "GET", "/debug/requests/" + TID)
        assert st == 200 and by_trace["trace_id"] == TID
        st, _, raw = _req(fe.port, "GET", "/metrics")
        text = raw.decode("utf-8")
        pat = (r'serving_request_latency_ms_bucket\{le="[^"]+"\} \d+'
               r' # \{trace_id="%s"\}' % TID)
        assert re.search(pat, text), text
        st, _, summ = _req(fe.port, "GET", "/debug/flight")
        assert st == 200 and summ["enabled"]
        assert any(r["request_id"] == "tr-1" and r["trace_id"] == TID
                   for r in summ["ring"])
        st, _, body = _req(fe.port, "GET", "/debug/requests/absent")
        assert st == 404 and body["error"]["code"] == "not_found"


def test_errors_echo_trace_id_in_body_and_headers(traced):
    fe, _ = _mlp_frontend()
    with fe:
        st, hdrs, body = _req(fe.port, "POST", "/v1/predict",
                              body={"x": 1}, headers={"traceparent": TP})
        assert st == 400 and body["error"]["code"] == "bad_request"
        assert body["trace_id"] == TID
        assert hdrs["x-trace-id"] == TID
        assert hdrs["traceparent"].startswith("00-%s-" % TID)
        st, _, body = _req(fe.port, "POST", "/v1/predict",
                           body={"x": 1},
                           headers={"traceparent": "not-a-traceparent"})
        assert st == 400
        assert len(body["trace_id"]) == 32 and body["trace_id"] != TID
        # keep-alive: a GET after a POST on one connection carries no trace
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=WAIT)
        try:
            conn.request("POST", "/v1/predict", json.dumps({"x": 1}),
                         {"traceparent": TP})
            r = conn.getresponse()
            r.read()
            assert r.getheader("x-trace-id") == TID
            conn.request("GET", "/nope")
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == 404 and "trace_id" not in body
            assert r.getheader("x-trace-id") is None
        finally:
            conn.close()


def test_sse_error_event_carries_trace_id(traced):
    fe, _ = _lm_frontend(max_new_tokens=64, max_context=96)
    with fe:
        st, hdrs, resp = _sse(
            fe.port, {"prompt": [3, 7, 1], "max_new_tokens": 64},
            headers={"traceparent": TP, "timeout-ms": "50"})
        if st == 200:
            errs = [d for e, d in resp if e == "error"]
            assert errs, resp
            assert errs[0]["code"] == "deadline_exceeded"
            assert errs[0]["trace_id"] == TID
        else:
            assert resp["trace_id"] == TID


# --- strict exposition conformance -------------------------------------------

def test_live_metrics_body_is_strictly_conformant(traced):
    fe, _ = _mlp_frontend()
    x = np.zeros((1, 10), np.float32)
    with fe:
        st, _, _b = _req(fe.port, "POST", "/v1/predict",
                         body={"inputs": {"data": x.tolist()}},
                         headers={"traceparent": TP})
        assert st == 200
        st, hdrs, raw = _req(fe.port, "GET", "/metrics")
        assert st == 200
    text = raw.decode("utf-8")
    _assert_prometheus_conformant(text)
    assert "serving_request_latency_ms_bucket" in text
    assert "http_requests_total" in text and "http_inflight" in text


def test_exposition_conformant_under_hostile_labels_and_help():
    reg = telemetry.Registry()
    reg.counter("c_total", help="multi\nline \\ help").inc()
    reg.gauge("g", labels={"path": 'a"b\\c\nd'}).set(1)
    reg.gauge("nan_g").set(float("nan"))
    h = reg.histogram("h_ms", buckets=(1, 10))
    h.observe(0.5)
    h.observe(5, exemplar='tr"ace\\id')
    h.observe(100)
    text = reg.exposition()
    _assert_prometheus_conformant(text)
    assert '{path="a\\"b\\\\c\\nd"}' in text
    assert "# HELP c_total multi\\nline \\\\ help" in text
    for bad in ("m_no_type 1\n",
                "# TYPE h histogram\n# HELP h h\n"
                'h_bucket{le="1"} 2\nh_bucket{le="+Inf"} 1\n'
                "h_sum 3\nh_count 1\n",
                '# HELP b b\n# TYPE b counter\nb{l="x\ny"} 1\n'):
        with pytest.raises(AssertionError):
            _assert_prometheus_conformant(bad)


# --- what the port adds ------------------------------------------------------

def test_routes_equal_the_jax_package():
    """The pure route functions against the reference's on the same
    inputs: the status tables (an unknown code 400 at submit, 500 after),
    the error body, the header-over-body parses and both input forms."""
    assert mt.serving.frontend.__all__ == jfrontend.__all__
    assert {"FrontendConfig", "HttpFrontend"} <= set(mt.serving.__all__)
    jr = jfrontend.routes
    for code in sorted(set(routes._SUBMIT_STATUS) | set(routes._RESULT_STATUS)
                       | {"mystery"}):
        for submit in (True, False):
            assert routes.status_for_error(code, submit) == \
                jr.status_for_error(code, submit)
    assert routes.status_for_error("mystery", True) == 400
    assert routes.status_for_error("mystery", False) == 500
    assert routes.RETRYABLE_CODES == jr.RETRYABLE_CODES
    assert routes.error_body("shed", "m", "r", "t") == \
        jr.error_body("shed", "m", "r", "t")
    assert routes.parse_timeout_ms("25", {"timeout_ms": 900}) == 25.0
    assert routes.parse_timeout_ms(None, {"timeout_ms": 900}) == 900.0
    assert routes.parse_priority(None, {"priority": "batch"}) == 1
    assert routes.parse_priority("interactive", {"priority": "batch"}) == 0
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    body = {"inputs": {"a": x.tolist(),
                       "b": {"b64": base64.b64encode(x).decode(),
                             "shape": [2, 3], "dtype": "float32"}}}
    got, want = routes.parse_predict_inputs(body), jr.parse_predict_inputs(body)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    g = {"prompt": [1, "2"], "max_new_tokens": "3", "temperature": 0.5,
         "seed": 4}
    assert routes.parse_generate_body(g) == jr.parse_generate_body(g)
    assert routes.wait_budget_s(None, 1000) == jr.wait_budget_s(None, 1000)
    assert routes.wait_budget_s(0, 0) == jr.wait_budget_s(0, 0)
    assert sse_event("token", {"token": 1, "index": 0}) == \
        jfrontend.sse_event("token", {"token": 1, "index": 0})


def test_predict_response_takes_tensors_to_the_host():
    """A tensor output reaches json and base64 as a host array: the same
    body as the numpy array's."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for enc in ("json", "b64"):
        want = routes.predict_response([a], "r", enc)
        assert routes.predict_response([torch.from_numpy(a)], "r", enc) \
            == want
        assert routes.predict_response([mt.nd.array(a, ctx="cpu")], "r",
                                       enc) == want


def _script(fe, srv):
    """The differential script: (label, status, error code, Retry-After
    present, x-request-id echoed, payload) of each request."""
    rng = np.random.RandomState(5)
    x1 = rng.uniform(-1, 1, (1, 10)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (3, 10)).astype(np.float32)
    x5 = rng.uniform(-1, 1, (5, 10)).astype(np.float32)
    b64 = {"b64": base64.b64encode(x3).decode(), "shape": [3, 10],
           "dtype": "float32"}
    calls = [
        ("healthz", "GET", "/healthz", None, {}),
        ("predict_json", "POST", "/v1/predict",
         {"inputs": {"data": x1.tolist()}}, {}),
        ("predict_b64", "POST", "/v1/predict",
         {"inputs": {"data": b64}, "encoding": "b64"}, {}),
        ("predict_batch_class", "POST", "/v1/predict",
         {"inputs": {"data": x3.tolist()}}, {"x-priority": "batch"}),
        ("too_large", "POST", "/v1/predict",
         {"inputs": {"data": x5.tolist()}}, {}),
        ("bad_json", "POST", "/v1/predict", b"{not json", {}),
        ("bad_priority", "POST", "/v1/predict",
         {"inputs": {"data": x1.tolist()}}, {"x-priority": "turbo"}),
        ("bad_timeout", "POST", "/v1/predict",
         {"inputs": {"data": x1.tolist()}}, {"timeout-ms": "-3"}),
        ("no_route", "POST", "/v1/nope", {}, {}),
        ("generate_empty", "POST", "/v1/generate", {}, {}),
        ("get_404", "GET", "/nope", None, {}),
    ]
    out = []
    for i, (label, method, path, body, hdrs) in enumerate(calls):
        rid = "diff-%d" % i
        st, h, payload = _req(fe.port, method, path,
                              body=None if isinstance(body, bytes) else body,
                              raw_body=body if isinstance(body, bytes)
                              else None,
                              headers=dict(hdrs, **{"x-request-id": rid}))
        code = payload["error"]["code"] if isinstance(payload, dict) and \
            "error" in payload else None
        out.append((label, st, code, "retry-after" in h,
                    h.get("x-request-id") == rid, payload))
    return out


def _decode_outputs(payload):
    outs = []
    for o in payload["outputs"]:
        if isinstance(o, dict):
            o = np.frombuffer(base64.b64decode(o["b64"]),
                              np.dtype(o["dtype"])).reshape(o["shape"])
        outs.append(np.asarray(o, np.float32))
    return outs


def test_the_same_script_through_both_frontends():
    """The same requests through the JAX package's HttpFrontend and the
    port's, the MLP's numpy parameters given to both servers as they are
    and the LM's carried into the port's decode model by
    ``params_from_numpy`` (inside ``InferenceServer``): per request the
    same status, error code and Retry-After presence, the request id
    echoed, predict outputs within rtol 1e-5 / atol 1e-6, greedy SSE and
    JSON token ids equal; then the shed and the deadline rejection."""
    results = {}
    for pkg in (mx, mt):
        fe, srv = _mlp_frontend(pkg=pkg)
        with fe:
            results[pkg] = _script(fe, srv)
    for (label, *j), (_l, *t) in zip(results[mx], results[mt]):
        assert j[:4] == t[:4], (label, j[:4], t[:4])
        assert t[3], label                   # x-request-id echoed
        if label.startswith("predict") and j[0] == 200:
            for a, b in zip(_decode_outputs(t[4]), _decode_outputs(j[4])):
                np.testing.assert_allclose(a, b, **TOL)
    assert [r[1] for r in results[mt]] == [200, 200, 200, 200, 413, 400,
                                           400, 400, 404, 400, 404]
    # admission: a batch-class shed with Retry-After, on both
    shed = {}
    for pkg in (mx, mt):
        fe, srv = _mlp_frontend(buckets=(8,), max_delay_ms=400.0,
                                queue_depth=8, fe_kw={"shed_pct": 25.0},
                                pkg=pkg)
        x = np.zeros((1, 10), np.float32)
        with fe:
            parked = [srv.submit(data=x) for _ in range(4)]
            st, h, body = _req(fe.port, "POST", "/v1/predict",
                               body={"inputs": {"data": x.tolist()}},
                               headers={"x-priority": "batch",
                                        "x-request-id": "shed-1"})
            shed[pkg] = (st, body["error"]["code"], "retry-after" in h,
                         h["x-request-id"])
            for r in parked:
                r.get(WAIT)
    assert shed[mx] == shed[mt] == (429, "shed", True, "shed-1")
    # generate: greedy SSE and JSON tokens
    prompts = ([3, 7, 1], [5, 9, 2, 8, 4, 4, 1], [11])
    toks = {}
    for pkg in (mx, mt):
        fe, _ = _lm_frontend(max_new_tokens=6, pkg=pkg)
        with fe:
            got = []
            for i, p in enumerate(prompts):
                st, h, events = _sse(fe.port, {"prompt": p},
                                     headers={"x-request-id": "g-%d" % i})
                assert st == 200 and h["x-request-id"] == "g-%d" % i
                assert events[-1] == ("done", {
                    "finish_reason": "max_tokens", "tokens": 6,
                    "request_id": "g-%d" % i})
                got.append(_sse_tokens(events))
            st, _, body = _req(fe.port, "POST", "/v1/generate",
                               body={"prompt": prompts[0], "stream": False})
            assert st == 200
            got.append(body["tokens"])
            toks[pkg] = got
    assert toks[mt] == toks[mx]
    assert toks[mt][-1] == toks[mt][0]


def test_client_disconnect_cancels_the_stream_and_frees_its_slot():
    """A client that closes its socket after its 4th token: the handler's
    next write fails, it cancels the stream, the scheduler retires it with
    ``cancelled`` before ``max_new_tokens``, every slot comes free, and a
    stream beside it runs to its end unchanged."""
    fe, srv = _lm_frontend(max_new_tokens=24, slots=2, max_context=40)
    streams = []
    real = srv.submit_stream

    def keep(*a, **kw):
        s = real(*a, **kw)
        streams.append(s)
        return s

    srv.submit_stream = keep
    with fe:
        fe_port = fe.port
        want = srv.generate([5, 2, 9], max_new_tokens=24)
        streams.clear()
        other = {}
        t = threading.Thread(target=lambda: other.update(
            resp=_sse(fe_port, {"prompt": [5, 2, 9]})), daemon=True)
        conn = http.client.HTTPConnection("127.0.0.1", fe_port, timeout=WAIT)
        try:
            conn.request("POST", "/v1/generate",
                         json.dumps({"prompt": [3, 7, 1]}),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 200
            t.start()
            seen = 0
            for ev, _d in iter_sse(r):
                if ev == "token":
                    seen += 1
                    if seen == 4:
                        break
        finally:
            r.close()
            conn.close()
        t.join(WAIT)
        assert not t.is_alive()
        gone = streams[0]                # the first stream submitted
        deadline = time.monotonic() + WAIT
        while not gone.done or srv.decode_stats()["active"]:
            assert time.monotonic() < deadline, srv.decode_stats()
            time.sleep(0.01)
        assert gone.cancelled and gone.finish_reason == "cancelled"
        assert len(gone._tokens) < 24
        assert all(not c.active_slots() for c in srv._decode.caches)
    st, _, events = other["resp"]
    assert st == 200 and _sse_tokens(events) == want
