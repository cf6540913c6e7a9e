"""mxnet_tpu_torch.serving.frontend — the HTTP/1.1 network front-end.

Counterpart of ``mxnet_tpu/serving/frontend``: the socket over the
in-process ``InferenceServer``. Stdlib-only HTTP serving with SSE token
streaming, admission control (429/503 + Retry-After), deadline
propagation, interactive/batch QoS classes, Prometheus ``/metrics``,
``/healthz``/``/readyz``, and SIGTERM graceful drain. The model runs on
the card (``device`` of the server's replicas); the front end itself is
host code.

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving.frontend import FrontendConfig, HttpFrontend

    srv = serving.create_server("ckpt/m", epoch=1,
                                example_shapes={"data": (3, 224, 224)})
    fe = HttpFrontend(srv, FrontendConfig(port=8080))
    fe.install_signal_handlers()      # SIGTERM -> zero-drop drain
    fe.start(wait_ready=True)
    fe.serve_forever()
"""
from .admission import AdmissionController, AdmissionDecision
from .routes import BadRequest, status_for_error
from .server import FrontendConfig, HttpFrontend
from .sse import SSE_CONTENT_TYPE, iter_sse, sse_event

__all__ = [
    "AdmissionController", "AdmissionDecision", "BadRequest",
    "FrontendConfig", "HttpFrontend", "SSE_CONTENT_TYPE", "iter_sse",
    "sse_event", "status_for_error",
]
