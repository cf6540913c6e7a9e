"""Training modules (counterpart of ``mxnet_tpu/module``, reference
python/mxnet/module/): ``Module`` on one device or
data-parallel over several (through a kvstore), ``BucketingModule`` over
buckets that share its parameters, ``SequentialModule`` (a chain of
modules), ``PythonModule`` / ``PythonLossModule`` (modules without a
graph), their ``BaseModule`` training loop and the executor group."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module", "PythonLossModule", "PythonModule", "SequentialModule"]
