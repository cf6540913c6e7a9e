"""The HTTP front-door run the card scripts drive.

``chip_smoke.py`` (its ``serve_http`` phase) takes from here:

- ``SERVE_HTTP``: bench.py's ResNet-50 (``tools/resnet.py``) behind
  ``InferenceServer`` (the bucket ladder, the batch former's window, one
  replica, zero-copy staging) behind ``HttpFrontend`` on 127.0.0.1, port
  0; its traffic: ``clients`` closed-loop keep-alive clients sending
  ``requests`` requests of ``rows`` images each (``tools/serve_fixed.py``'s
  :func:`request_sizes` / :func:`request_images`) in the b64 form; the
  admission arm's ladder, window, queue, shed threshold, parked requests
  and in-flight cap; the generate arm: the serve phase's LM
  (``tools/lm.py``) with ``decode_replicas`` decode replicas, its fixed
  path bound at (1, ``decode_example_len``), a client that leaves after
  ``disconnect_after`` tokens of a ``disconnect_tokens``-token stream, and
  ``drain_streams`` streams open across a SIGTERM;
- the stdlib clients: :func:`request` (one JSON exchange on a kept-alive
  connection), :func:`sse` (one SSE stream, each event's arrival time) and
  the raw-tensor form (:func:`b64_array` / :func:`from_b64`).
"""
from __future__ import annotations

import base64
import http.client
import json
import time

import numpy as np

from ..serving.frontend import iter_sse

SERVE_HTTP = {"buckets": (1, 2, 4, 8, 16, 32), "max_delay_ms": 5.0,
              "replicas": 1, "clients": 8, "requests": 96, "rows": (1, 4),
              "timeout_ms": 60000.0,
              "admission": {"buckets": (32,), "max_delay_ms": 400.0,
                            "queue_depth": 8, "shed_pct": 25.0, "parked": 4,
                            "max_inflight": 2},
              "decode_replicas": 2, "decode_example_len": 512,
              "disconnect_after": 4, "disconnect_tokens": 200,
              "drain_streams": 2}


def b64_array(a) -> dict:
    """The raw-tensor form of a host array."""
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a).decode("ascii"),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def from_b64(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"])).reshape(d["shape"])


def connect(port, timeout):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)


def request(conn, method, path, body=None, headers=None):
    """One exchange on ``conn`` (kept alive): (status, lower-cased
    headers, the JSON payload or the raw bytes, seconds from sending to
    the payload parsed)."""
    t0 = time.monotonic()
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body)
    conn.request(method, path, data, {"Content-Type": "application/json",
                                      **(headers or {})})
    r = conn.getresponse()
    raw = r.read()
    hdrs = {k.lower(): v for k, v in r.getheaders()}
    payload = json.loads(raw) if raw and hdrs.get(
        "content-type", "").startswith("application/json") else raw
    return r.status, hdrs, payload, time.monotonic() - t0


def sse(port, body, headers=None, timeout=300.0, stop_after=None,
        on_event=None):
    """POST ``body`` to /v1/generate and read its SSE stream to the end,
    or close the socket after ``stop_after`` token events. Returns
    (status, headers, [(event, data)] or the error payload, [arrival
    seconds of each event, from the send]); ``on_event(event)`` is called
    as each arrives."""
    conn = connect(port, timeout)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        if r.status != 200:
            return r.status, hdrs, json.loads(r.read()), []
        events, times, tokens = [], [], 0
        for ev in iter_sse(r):
            events.append(ev)
            times.append(time.monotonic() - t0)
            if on_event is not None:
                on_event(ev)
            tokens += ev[0] == "token"
            if stop_after is not None and tokens >= stop_after:
                r.close()
                break
        return r.status, hdrs, events, times
    finally:
        conn.close()
