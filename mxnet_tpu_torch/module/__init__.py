"""Training modules (counterpart of ``mxnet_tpu/module``, reference
python/mxnet/module/): ``Module`` on one device, its ``BaseModule``
training loop and its executor group. ``BucketingModule``,
``SequentialModule`` and ``PythonModule`` are not ported."""
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "DataParallelExecutorGroup", "Module"]
