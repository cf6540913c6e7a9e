"""Training modules (counterpart of ``mxnet_tpu/module``, reference
python/mxnet/module/): ``Module`` on one device, ``BucketingModule`` over
buckets that share its parameters, their ``BaseModule`` training loop and
the executor group. ``SequentialModule`` and ``PythonModule`` are not
ported."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module"]
