"""HTTP/1.1 front-end over the in-process ``InferenceServer``.

Counterpart of ``mxnet_tpu/serving/frontend/server.py``: the same routes,
status codes, headers and drain. Dependency-free network serving (stdlib
``http.server`` threading server — one OS thread per connection, which is
the right shape here because every handler blocks on a
``Request``/``TokenStream`` future while the work runs on the card, driven
by the host engine's worker and the decode scheduler's loop):

- ``POST /v1/predict``   -> ``InferenceServer.submit()`` + wait; JSON in
  (``{"inputs": {...}}``), JSON out (``{"request_id", "outputs"}``)
- ``POST /v1/generate``  -> ``submit_stream()``; SSE token stream
  (default) or one JSON body with ``"stream": false``
- ``GET  /metrics``      -> the telemetry registry's Prometheus
  exposition, served with ``telemetry.CONTENT_TYPE_LATEST``
- ``GET  /healthz``      -> process liveness (always 200 while serving)
- ``GET  /readyz``       -> 200 only once every replica's bucket ladder
  is bound (a CUDA graph a bucket on the card) AND the server is not
  draining — the rolling-restart gate: traffic admitted now never stalls
  on a bind
- ``GET  /debug/requests/<id>`` and ``/debug/flight`` -> the flight
  recorder's span tree of one request, and its summary

Production behavior on top of the transport: admission control (429/503 +
``Retry-After``; ``frontend.admission``), per-request deadlines from the
``timeout-ms`` header feeding the batcher's reject-early feasibility
check, ``x-priority`` interactive/batch QoS classes mapped onto batcher
admission order, a ``request_id`` (``x-request-id`` or generated) echoed
in every response and annotated on the ``serving.http.request`` span, and
SIGTERM graceful drain through ``InferenceServer.stop(drain=True)`` —
in-flight requests and SSE streams all complete; only NEW work is refused.
Outputs reach the wire as host arrays (``routes.host_array``).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ... import telemetry
from ...telemetry import context as trace_context
from ...telemetry import flight as _flight
from ..batcher import ServingError
from . import routes
from .admission import AdmissionController
from .sse import SSE_CONTENT_TYPE, sse_event

_log = logging.getLogger("mxnet_tpu_torch")


@dataclass
class FrontendConfig:
    """Socket + admission knobs (``MXNET_HTTP_*`` env defaults read at
    construction)."""
    host: str = field(default_factory=lambda: os.environ.get(
        "MXNET_HTTP_HOST", "127.0.0.1"))
    #: listen port; 0 = ephemeral (tests — read it back from ``.port``)
    port: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_HTTP_PORT", "8080")))
    #: hard cap on concurrently-handled requests (503 above it)
    max_inflight: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_HTTP_MAX_INFLIGHT", "64")))
    #: batch-class shed threshold, percent of the batcher queue_depth
    shed_pct: float = field(default_factory=lambda: float(
        os.environ.get("MXNET_HTTP_SHED_PCT", "80")))


class _Httpd(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 RSTs simultaneous
    # connects the moment a burst outruns the accept loop — an overload
    # burst must shed with a 429/503, never a connection reset
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    """Per-connection handler; the owning HttpFrontend hangs off the
    ThreadingHTTPServer instance (``self.server.frontend``)."""

    protocol_version = "HTTP/1.1"
    # HTTP/1.1 keep-alive: JSON responses carry Content-Length; SSE
    # responses set Connection: close and close_connection explicitly
    # TCP_NODELAY: headers and body flush as separate writes, and Nagle
    # + delayed-ACK turns that into a ~40 ms stall per response on
    # loopback; SSE token latency needs immediate segments anyway
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        _log.debug("http: %s", fmt % args)

    # --- plumbing ---------------------------------------------------------
    @property
    def fe(self) -> "HttpFrontend":
        return self.server.frontend

    def _request_id(self) -> str:
        return self.headers.get("x-request-id") or \
            trace_context.mint_request_id()

    def _send_json(self, status: int, payload: dict, request_id: str,
                   retry_after_s: Optional[int] = None):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("x-request-id", request_id)
        ctx = getattr(self, "_trace", None)
        if ctx is not None:
            self.send_header("x-trace-id", ctx.trace_id)
            self.send_header("traceparent",
                             trace_context.to_traceparent(ctx))
        if retry_after_s is not None:
            self.send_header("Retry-After", str(int(retry_after_s)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, code: str, message: str,
                         request_id: str,
                         retry_after_s: Optional[int] = None):
        if retry_after_s is None and code in routes.RETRYABLE_CODES:
            retry_after_s = 1
        ctx = getattr(self, "_trace", None)
        self._send_json(status,
                        routes.error_body(
                            code, message, request_id,
                            trace_id=(ctx.trace_id if ctx is not None
                                      else None)),
                        request_id, retry_after_s)

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        return self.rfile.read(length) if length > 0 else b""

    # --- GET --------------------------------------------------------------
    def do_GET(self):
        self._trace = None  # keep-alive: don't leak a prior POST's trace
        rid = self._request_id()
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok"}, rid)
        elif self.path == "/readyz":
            if self.fe.ready():
                self._send_json(200, {"status": "ready"}, rid)
            else:
                reason = ("draining" if self.fe.admission.draining()
                          else "warming")
                self._send_json(503, {"status": reason}, rid,
                                retry_after_s=1)
        elif self.path == "/metrics":
            body = telemetry.registry.exposition().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", telemetry.CONTENT_TYPE_LATEST)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/debug/requests/"):
            # one request's assembled span tree, by request_id or
            # trace_id — the landing page of an exemplar / error echo
            ident = self.path[len("/debug/requests/"):]
            tree = _flight.request_tree(ident) if ident else None
            if tree is None:
                self._send_error_json(404, "not_found",
                                      "no recorded request %r" % ident,
                                      rid)
            else:
                self._send_json(200, tree, rid)
        elif self.path == "/debug/flight":
            self._send_json(200, _flight.summary(), rid)
        else:
            self._send_error_json(404, "not_found",
                                  "no route %r" % self.path, rid)

    # --- POST -------------------------------------------------------------
    def do_POST(self):
        # trace context is minted (or continued from a W3C traceparent
        # header) at the network edge, installed on this handler thread,
        # and rides the Request/TokenStream through batcher + scheduler —
        # every span below stamps the same trace_id
        ctx = trace_context.from_headers(self.headers)
        self._trace = ctx
        rid = ctx.request_id
        if self.path not in ("/v1/predict", "/v1/generate"):
            self._send_error_json(404, "not_found",
                                  "no route %r" % self.path, rid)
            return
        raw = self._read_body()
        route = self.path.rsplit("/", 1)[-1]
        with trace_context.use(ctx), \
                telemetry.span("serving.http.request", domain="serving",
                               route=route, **ctx.stamps()) as sp:
            try:
                body = routes.parse_json_body(raw)
                priority = routes.parse_priority(
                    self.headers.get("x-priority"), body)
                timeout_ms = routes.parse_timeout_ms(
                    self.headers.get("timeout-ms"), body)
            except routes.BadRequest as e:
                self._send_error_json(400, "bad_request", e.message, rid)
                return
            decision, _n = self.fe.admission.decide(priority)
            if decision is not None:
                sp.annotate(shed=decision.code)
                self._send_error_json(decision.status, decision.code,
                                      decision.message, rid,
                                      decision.retry_after_s)
                return
            try:  # admitted: paired exit() in finally
                if self.path == "/v1/predict":
                    self._predict(body, priority, timeout_ms, rid, sp)
                else:
                    self._generate(body, priority, timeout_ms, rid, sp)
            finally:
                self.fe.admission.exit()

    def _predict(self, body: dict, priority: int,
                 timeout_ms: Optional[float], rid: str, sp):
        srv = self.fe.server
        try:
            feed = routes.parse_predict_inputs(body)
        except routes.BadRequest as e:
            self._send_error_json(400, "bad_request", e.message, rid)
            return
        try:
            req = srv.submit(timeout_ms=timeout_ms, priority=priority,
                             request_id=rid, **feed)
        except ServingError as e:
            self._send_error_json(routes.status_for_error(e.code, True),
                                  e.code, str(e), rid)
            return
        try:
            outs = req.get(routes.wait_budget_s(
                timeout_ms, srv.config.timeout_ms))
        except ServingError as e:
            self._send_error_json(routes.status_for_error(e.code, False),
                                  e.code, str(e), rid)
            return
        sp.annotate(rows=req.rows, latency_ms=req.latency_ms)
        enc = "b64" if body.get("encoding") == "b64" else "json"
        self._send_json(200, routes.predict_response(outs, rid, enc), rid)

    def _generate(self, body: dict, priority: int,
                  timeout_ms: Optional[float], rid: str, sp):
        srv = self.fe.server
        try:
            prompt, max_new, temperature, seed = \
                routes.parse_generate_body(body)
        except routes.BadRequest as e:
            self._send_error_json(400, "bad_request", e.message, rid)
            return
        want_stream = body.get("stream")
        if want_stream is None:  # default SSE unless the client asked
            want_stream = "application/json" not in \
                self.headers.get("Accept", "")
        try:
            stream = srv.submit_stream(prompt, max_new,
                                       timeout_ms=timeout_ms,
                                       temperature=temperature, seed=seed,
                                       request_id=rid)
        except ServingError as e:
            self._send_error_json(routes.status_for_error(e.code, True),
                                  e.code, str(e), rid)
            return
        if not want_stream:
            try:
                toks = stream.tokens(routes.wait_budget_s(timeout_ms, 0))
            except ServingError as e:
                self._send_error_json(
                    routes.status_for_error(e.code, False), e.code,
                    str(e), rid)
                return
            sp.annotate(tokens=len(toks),
                        finish_reason=stream.finish_reason)
            self._send_json(200, {"request_id": rid, "tokens": toks,
                                  "finish_reason": stream.finish_reason},
                            rid)
            return
        # SSE: status goes out before tokens exist, so mid-stream
        # failures travel in-band as an `error` event; Connection: close
        # delimits the stream (no Content-Length on a live stream)
        self.send_response(200)
        self.send_header("Content-Type", SSE_CONTENT_TYPE)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("x-request-id", rid)
        ctx = getattr(self, "_trace", None)
        if ctx is not None:
            self.send_header("x-trace-id", ctx.trace_id)
            self.send_header("traceparent",
                             trace_context.to_traceparent(ctx))
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        n = 0
        try:
            try:
                for tok in stream:
                    self.wfile.write(sse_event(
                        "token", {"token": tok, "index": n}))
                    self.wfile.flush()
                    n += 1
            except ServingError as e:
                sp.annotate(tokens=n, error=e.code)
                evt = {"code": e.code, "message": str(e),
                       "request_id": rid}
                if ctx is not None:
                    evt["trace_id"] = ctx.trace_id
                self.wfile.write(sse_event("error", evt))
                self.wfile.flush()
                return
            sp.annotate(tokens=n, finish_reason=stream.finish_reason)
            self.wfile.write(sse_event(
                "done", {"finish_reason": stream.finish_reason,
                         "tokens": n, "request_id": rid}))
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: free the decode slot now
            stream.cancel()
            sp.annotate(tokens=n, error="client_disconnected")


class HttpFrontend:
    """Owns the listening socket, its serve thread, background ladder
    warmup, and the drain choreography. ``server`` is a (started or not)
    ``InferenceServer``; ``start()`` starts it if needed."""

    def __init__(self, server, config: Optional[FrontendConfig] = None):
        self.server = server
        self.config = config or FrontendConfig()
        self.admission = AdmissionController(
            server, max_inflight=self.config.max_inflight,
            shed_pct=self.config.shed_pct)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._warm_done = False
        self._stopped = threading.Event()
        self._stop_once = threading.Lock()
        self._stop_started = False

    # --- lifecycle --------------------------------------------------------
    def start(self, wait_ready: bool = False,
              ready_timeout_s: float = 120.0) -> "HttpFrontend":
        if self._httpd is not None:
            raise ServingError("frontend already started")
        if not self.server._started:
            self.server.start()
        httpd = _Httpd((self.config.host, self.config.port), _Handler)
        httpd.daemon_threads = True
        httpd.frontend = self
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True, name="http-frontend")
        self._thread.start()
        # warm the ladder off-thread so the socket answers /healthz and
        # sheds load during warmup instead of hanging cold clients
        warm = threading.Thread(target=self._warm, daemon=True,
                                name="http-warmup")
        warm.start()
        if wait_ready:
            deadline = time.monotonic() + ready_timeout_s
            while not self.ready():
                if time.monotonic() >= deadline:
                    raise ServingError("frontend not ready within %gs"
                                       % ready_timeout_s)
                time.sleep(0.01)
        return self

    def _warm(self):
        try:
            self.server.warm()
        except BaseException:
            _log.exception("http frontend ladder warmup failed")
        finally:
            self._warm_done = True

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise ServingError("frontend not started")
        return self._httpd.server_address[1]

    def ready(self) -> bool:
        """The /readyz predicate: warm, started, and not draining."""
        return (self._warm_done and not self.admission.draining()
                and self.server.ready())

    def stop(self, drain: bool = True,
             deadline_ms: Optional[float] = None):
        """Drain and stop: flip admission to draining (new requests get
        503 + Retry-After, /readyz goes unready so balancers stop
        routing here), let the inference server finish everything queued
        (``stop(drain=True)`` — in-flight SSE streams run to their
        natural finish), wait for the last handler to flush, then close
        the socket. Idempotent; safe from a signal-handler thread."""
        with self._stop_once:
            already = self._stop_started
            self._stop_started = True
        if already:  # second stopper: just wait out the first (no hold)
            self._stopped.wait()
            return
        self.admission.set_draining()
        try:
            self.server.stop(drain=drain, deadline_ms=deadline_ms)
            # handlers past admission are still streaming results out;
            # give them until the drain deadline (default: as long as
            # they need — their futures have already resolved)
            limit = None if deadline_ms is None \
                else time.monotonic() + deadline_ms / 1e3
            while self.admission.inflight() > 0:
                if limit is not None and time.monotonic() >= limit:
                    break
                time.sleep(0.005)
        finally:
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._thread.join()
            self._stopped.set()

    def serve_forever(self):
        """Block the calling thread until ``stop()`` completes (the
        subprocess entry point: install_signal_handlers + serve_forever
        is a whole server process)."""
        self._stopped.wait()

    def install_signal_handlers(self, signals=(signal.SIGTERM,)):
        """SIGTERM = rolling-restart drain: handlers must return
        immediately, so the drain runs on a daemon thread. Main-thread
        only (CPython signal delivery contract)."""
        def _drain(signum, frame):
            _log.info("http frontend: signal %d -> graceful drain",
                      signum)
            threading.Thread(target=self.stop, kwargs={"drain": True},
                             daemon=True, name="http-drain").start()
        for s in signals:
            signal.signal(s, _drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))
