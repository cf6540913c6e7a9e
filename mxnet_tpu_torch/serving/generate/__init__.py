"""Continuous batching for autoregressive decode (KV-cache serving).

Counterpart of ``mxnet_tpu/serving/generate/``: an Orca-style
:class:`DecodeScheduler` re-forms the decode batch every step as sequences
finish, :class:`KVCacheManager` owns slot-allocated KV slabs behind engine
variables, and :class:`DecodePrograms` holds the bucketed prefill ladder,
the one decode step and the admit. Prefill attention runs the hand-written
CUDA flash-attention kernel on the card.
"""
from .kv_cache import AdmitPlan, KVCacheManager
from .model import DecodeModel, DecodeSpec, params_from_numpy
from .programs import DecodePrograms
from .scheduler import DecodeScheduler, GenerateConfig
from .spec import sample_token
from .stream import TokenStream

__all__ = [
    "AdmitPlan", "DecodeModel", "DecodeSpec", "DecodePrograms",
    "DecodeScheduler", "GenerateConfig", "KVCacheManager", "TokenStream",
    "params_from_numpy", "sample_token",
]
