"""Continuous batching for autoregressive decode (KV-cache serving).

Counterpart of ``mxnet_tpu/serving/generate/``: an Orca-style
:class:`DecodeScheduler` re-forms the decode batch every step as sequences
finish, :class:`KVCacheManager` owns slot-allocated KV slabs and
:class:`PagedKVCacheManager` a block pool with prefix sharing, behind
engine variables, and :class:`DecodePrograms` /
:class:`PagedDecodePrograms` hold the bucketed prefill ladder, the one
decode step (optionally one CUDA graph) and the admit, and
:class:`SpecDecoder` decodes speculatively (a draft's k steps, one verify
of the target). The unpaged prefill's attention runs the hand-written
CUDA flash-attention kernel on the card; f32, bf16 and int8 KV; int8 /
fp8 weights through ``mxnet_tpu_torch.quant``.
"""
from .kv_cache import AdmitPlan, KVCacheManager
from .model import DecodeModel, DecodeSpec, params_from_numpy
from .paged import TRASH_BLOCK, PagedKVCacheManager
from .programs import DecodePrograms, PagedDecodePrograms
from .scheduler import DecodeScheduler, GenerateConfig
from .spec import SpecDecoder, accept_greedy, accept_sampled, sample_token
from .stream import TokenStream

__all__ = [
    "AdmitPlan", "DecodeModel", "DecodeSpec", "DecodePrograms",
    "DecodeScheduler", "GenerateConfig", "KVCacheManager",
    "PagedDecodePrograms", "PagedKVCacheManager", "SpecDecoder",
    "TRASH_BLOCK", "TokenStream", "accept_greedy", "accept_sampled",
    "params_from_numpy", "sample_token",
]
