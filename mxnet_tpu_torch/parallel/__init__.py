"""Parallelism: the multi-process runtime (:mod:`.dist`).

Counterpart of ``mxnet_tpu/parallel/``. Only ``dist`` is ported: the
process group on ``torch.distributed`` that the collective ``dist_*``
kvstores reduce over. The meshes, collectives, ZeRO, pipeline, tensor
and sequence parallelism and the mixture of experts come later.
"""
from . import dist

__all__ = ["dist"]
