"""Route-level request/response logic for the HTTP front-end.

Counterpart of ``mxnet_tpu/serving/frontend/routes.py``. Pure functions between the wire and ``InferenceServer`` — the HTTP
handler (``frontend.server``) owns sockets and headers, this module owns
parsing, validation, and the ``ServingError`` code -> HTTP status map,
so every mapping is unit-testable without a socket.

Status vocabulary:

===================  =====================  ============================
ServingError code    at submit / admission  mid-flight (result wait)
===================  =====================  ============================
queue_full           429 + Retry-After      —
shed                 429 + Retry-After      —
deadline_exceeded    429 + Retry-After      504 (expired in queue)
too_large            413                    —
overloaded           503 + Retry-After      —
shutting_down        503 + Retry-After      503
shutdown             503                    503
dispatch_error       —                      500
wait_timeout         —                      504
cancelled            —                      499 (client closed)
===================  =====================  ============================

A submit-time ``deadline_exceeded`` is BACKPRESSURE (the reject-early
feasibility check said "retry later or relax the deadline") so it maps
to 429; once a request is admitted, the same code means the deadline
genuinely passed — a timeout, 504.
"""
from __future__ import annotations

import base64
import binascii
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..batcher import ServingError

#: codes that carry a Retry-After header on the rejection
RETRYABLE_CODES = frozenset(
    {"queue_full", "shed", "deadline_exceeded", "overloaded",
     "shutting_down"})

_SUBMIT_STATUS = {
    "queue_full": 429,
    "shed": 429,
    "deadline_exceeded": 429,
    "too_large": 413,
    "overloaded": 503,
    "shutting_down": 503,
    "shutdown": 503,
}

_RESULT_STATUS = {
    "deadline_exceeded": 504,
    "wait_timeout": 504,
    "shutting_down": 503,
    "shutdown": 503,
    "dispatch_error": 500,
    "cancelled": 499,
}


def status_for_error(code: str, submit_time: bool) -> int:
    """HTTP status for a structured ServingError code. Unknown codes are
    a server-side defect -> 500 (never let a new code turn into a silent
    200)."""
    table = _SUBMIT_STATUS if submit_time else _RESULT_STATUS
    return table.get(code, 400 if submit_time else 500)


def error_body(code: str, message: str, request_id: str,
               trace_id: Optional[str] = None) -> dict:
    """Structured error payload. When the request arrived with (or was
    assigned) a trace context, the trace id is echoed so the caller can
    pull the request's span tree from ``GET /debug/requests/<id>``."""
    body = {"error": {"code": code, "message": message},
            "request_id": request_id}
    if trace_id:
        body["trace_id"] = trace_id
    return body


class BadRequest(Exception):
    """Malformed client input -> 400 with a structured body."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


def parse_json_body(raw: bytes) -> dict:
    if not raw:
        raise BadRequest("empty body (expected a JSON object)")
    try:
        body = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise BadRequest("invalid JSON body: %s" % e)
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    return body


def parse_timeout_ms(header_val: Optional[str],
                     body: dict) -> Optional[float]:
    """Per-request deadline: the ``timeout-ms`` header wins over the
    body's ``timeout_ms`` (a header is what proxies and gateways can
    stamp without parsing the payload); None = server default."""
    raw = header_val if header_val is not None else body.get("timeout_ms")
    if raw is None:
        return None
    try:
        t = float(raw)
    except (TypeError, ValueError):
        raise BadRequest("timeout-ms must be a number, got %r" % (raw,))
    if t <= 0:
        raise BadRequest("timeout-ms must be > 0, got %g" % t)
    return t


def parse_priority(header_val: Optional[str], body: dict) -> int:
    """QoS class: ``x-priority`` header or body ``priority`` —
    ``interactive`` (default, 0) | ``batch`` (1)."""
    raw = header_val if header_val is not None else body.get("priority")
    if raw is None:
        return 0
    name = str(raw).strip().lower()
    if name in ("interactive", "0"):
        return 0
    if name in ("batch", "1"):
        return 1
    raise BadRequest("x-priority must be 'interactive' or 'batch', "
                     "got %r" % (raw,))


def parse_predict_inputs(body: dict) -> Dict[str, np.ndarray]:
    """``{"inputs": {name: value}}`` -> float32 arrays (a leading batch
    axis is the submit() contract, validated server-side).

    Two value forms: a nested JSON list, or the raw-tensor form
    ``{"b64": <base64 of the C-order buffer>, "shape": [...],
    "dtype": "float32"}`` — base64 + ``frombuffer`` skips the per-float
    JSON parse, which is what a large request (an image) pays for on the
    host."""
    inputs = body.get("inputs")
    if not isinstance(inputs, dict) or not inputs:
        raise BadRequest('body must carry {"inputs": {name: array}}')
    feed = {}
    for name, val in inputs.items():
        try:
            if isinstance(val, dict):
                raw = base64.b64decode(val["b64"])
                arr = np.frombuffer(raw, dtype=np.dtype(
                    str(val.get("dtype", "float32"))))
                feed[str(name)] = arr.reshape(
                    [int(d) for d in val["shape"]]).astype(
                        np.float32, copy=False)
            else:
                feed[str(name)] = np.asarray(val, dtype=np.float32)
        except (KeyError, ValueError, TypeError, binascii.Error) as e:
            raise BadRequest("input %r is not array-like: %s" % (name, e))
    return feed


def parse_generate_body(body: dict) -> Tuple[list, Optional[int], float,
                                             Optional[int]]:
    """-> (prompt, max_new_tokens, temperature, seed)."""
    prompt = body.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not prompt:
        raise BadRequest('body must carry {"prompt": [token ids]}')
    try:
        prompt = [int(t) for t in prompt]
    except (TypeError, ValueError):
        raise BadRequest("prompt must be a list of integer token ids")
    max_new = body.get("max_new_tokens")
    if max_new is not None:
        try:
            max_new = int(max_new)
        except (TypeError, ValueError):
            raise BadRequest("max_new_tokens must be an integer")
    try:
        temperature = float(body.get("temperature", 0.0))
    except (TypeError, ValueError):
        raise BadRequest("temperature must be a number")
    seed = body.get("seed")
    if seed is not None:
        try:
            seed = int(seed)
        except (TypeError, ValueError):
            raise BadRequest("seed must be an integer")
    return prompt, max_new, temperature, seed


def host_array(o) -> np.ndarray:
    """A numpy array of one output. The server publishes host arrays; a
    tensor (on the card or not) is copied to the host here, so no device
    tensor ever reaches ``json`` or ``base64``."""
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().numpy()
    if hasattr(o, "asnumpy"):
        return o.asnumpy()
    return np.asarray(o)


def predict_response(req_outputs, request_id: str,
                     encoding: str = "json") -> dict:
    """``encoding="b64"`` (the request's ``"encoding"`` field) returns
    each output as the raw-tensor dict instead of a nested list —
    symmetric with the b64 input form and off the JSON float-serialize
    path for large outputs."""
    if encoding == "b64":
        outs = []
        for o in req_outputs:
            a = np.ascontiguousarray(host_array(o))
            outs.append({"b64": base64.b64encode(a).decode("ascii"),
                         "shape": list(a.shape), "dtype": str(a.dtype)})
        return {"request_id": request_id, "outputs": outs}
    return {"request_id": request_id,
            "outputs": [host_array(o).tolist() for o in req_outputs]}


def wait_budget_s(timeout_ms: Optional[float], default_ms: float) -> float:
    """Result-wait budget: the request deadline plus grace, so a request
    failed by the former surfaces its structured code rather than a
    blunt wait_timeout (mirrors InferenceServer.predict)."""
    t = default_ms if timeout_ms is None else timeout_ms
    return (t / 1e3 + 60.0) if t and t > 0 else 3600.0


def serving_error(e: BaseException) -> ServingError:
    """Normalize any dispatch-side exception to a structured error."""
    if isinstance(e, ServingError):
        return e
    return ServingError("%s: %s" % (type(e).__name__, e), "dispatch_error")
