"""mxnet_tpu_torch.serving: the dynamic-batching inference server and the
continuous-batching generate path.

Counterpart of ``mxnet_tpu/serving``: concurrent requests coalesce into
micro-batches (``BatchFormer``), pad to the nearest configured batch
bucket and run through a bucketed executor cache (``BucketCache``: one
``Predictor`` bind a bucket, the weights shared; on a card a CUDA graph a
bucket) dispatched through the host engine (``InferenceServer``), with
QPS / latency / occupancy / cache metrics (``ServingMetrics``). Failures
are structured ``ServingError``s.

The ``generate`` subpackage is the autoregressive-decode workload on the
same server: ``InferenceServer.generate()`` / ``submit_stream()`` when
constructed with ``decode=GenerateConfig(...)``.

    from mxnet_tpu_torch import serving

    srv = serving.create_server("ckpt/m", epoch=1,
                                example_shapes={"data": (3, 224, 224)},
                                config=serving.ServingConfig(buckets=(1, 4, 8)))
    with srv:
        out = srv.predict(data=img[None])          # sync
        req = srv.submit(data=img[None])           # async future
        out = req.get(timeout=1.0)
    print(srv.metrics.get_name_value())

The ``frontend`` subpackage is the HTTP/1.1 front door over the server:
``POST /v1/predict``, ``POST /v1/generate`` (SSE), ``/metrics``,
``/healthz`` / ``/readyz``, admission control and SIGTERM drain
(``HttpFrontend(srv, FrontendConfig(port=8080)).start()``).
"""
from .batcher import (PRIORITY_BATCH, PRIORITY_INTERACTIVE, BatchFormer,
                      Request, ServingError)
from .bucket_cache import BucketCache
from .frontend import FrontendConfig, HttpFrontend
from .generate import (DecodeModel, DecodePrograms, DecodeScheduler,
                       DecodeSpec, GenerateConfig, KVCacheManager,
                       PagedDecodePrograms, PagedKVCacheManager,
                       TokenStream)
from .metrics import ServingBatchEndParam, ServingMetrics
from .server import InferenceServer, ServingConfig, create_server
from .staging import StagingPool
from .tuner import BucketTuner

__all__ = [
    "BatchFormer", "Request", "ServingError", "BucketCache",
    "FrontendConfig", "HttpFrontend",
    "PRIORITY_INTERACTIVE", "PRIORITY_BATCH",
    "ServingBatchEndParam", "ServingMetrics", "InferenceServer",
    "ServingConfig", "create_server", "StagingPool", "BucketTuner",
    "DecodeModel", "DecodeSpec", "DecodePrograms", "KVCacheManager",
    "PagedDecodePrograms", "PagedKVCacheManager",
    "DecodeScheduler", "GenerateConfig", "TokenStream",
]
