"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

A second package beside ``mxnet_tpu`` (the JAX reference, unchanged). Module
paths and class names follow the reference so each module's counterpart is
easy to find; inside, the code is plain PyTorch on tensors with an explicit
``device``. Every Pallas kernel the reference runs on a ported path is a
hand-written CUDA kernel here (``ops/kernels/``), built with ``nvcc`` at
first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise (``context.py``).

Ported so far: the continuous-batching generate path
(``serving.generate``) with its flash-attention forward kernel, and the
training path ``models.get_symbol`` -> ``Symbol.simple_bind`` ->
``initializer`` / ``Executor.copy_params_from`` -> ``Executor.forward`` /
``backward`` -> ``optimizer.Updater`` (SGD momentum, Adam), with the
flash-attention backward and the fused update kernels; and
``module.Module.fit`` over ``io.NDArrayIter`` with ``metric`` and
``callback`` on ResNet / LeNet / MLP (Convolution, Pooling, BatchNorm),
with the ``conv_wgrad`` kernel for the 3x3 weight gradients; and the
recurrent cells (``rnn``) with the fused ``RNN`` op, whose LSTM steps run
the ``lstm_step`` kernel (the LSTM language model through ``Module.fit``);
and the user-extension surface: imperative ``autograd`` over PyTorch's
graph, Python custom operators (``operator``, the ``Custom`` op) and
``rtc``, user CUDA C compiled at run time by NVRTC and launched with the
caller's grid and block; and the bucketed recurrent LM as MXNet's
``lstm_bucketing.py`` trains it: ``random`` (a generator a device) with
``Dropout``, ``DropoutCell`` / ``ZoneoutCell`` and the ``RNN`` op's
dropout, ``rnn.BucketSentenceIter``, ``module.BucketingModule``, and the
checkpoints (``nd.save`` / ``nd.load``, symbol JSON, optimizer states,
``Module.save_checkpoint`` / ``Module.load``) in the JAX package's files,
and the reference's through ``interop``; and ``telemetry`` (spans, the
metrics registry, trace context, the flight recorder) with ``profiler``,
whose dump puts the host spans and the card's kernels on one timeline;
and the fixed-shape serving stack: ``predict`` (``Predictor``, one CUDA
graph a bound shape), ``quant`` (``QuantizedPredictor``) and ``serving``
(``InferenceServer`` with its batch former, bucket cache, staging pool and
tuner, fronting the generate path too) behind ``serving.frontend``'s HTTP
/ SSE front door; and the sequence ops (``SequenceMask`` / ``Last`` /
``Reverse``, ``softmax_cross_entropy``), the creation and sampling ops and
``lr_scheduler``; and the rest of training: the optimizer zoo, ``Monitor``,
``SequentialModule`` / ``PythonModule`` / ``PythonLossModule``,
``FeedForward`` and the reference's top-level names (``Variable``,
``Group``, ``Context``, ``seed``, ...); and communication: ``kvstore``
(local, device and the collective ``dist_*`` stores over
``parallel.dist``'s ``torch.distributed`` group), the parameter server
(``kvstore_server``) and ``Module`` data-parallel over several contexts;
and the engine: ``engine`` (the native dependency engine, capture/replay,
trace-and-fuse, the sanitizer), ``progcache`` (the persistent program
cache) and ``analysis.compile_witness``.
"""
from . import (analysis, autograd, base, callback, context, engine,
               executor, initializer, interop, io, kvstore, kvstore_server,
               lr_scheduler, metric, model, models, module, monitor, ndarray,
               operator, optimizer, parallel, predict, profiler, progcache,
               quant, random, rnn, rtc, serving, symbol, telemetry)
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .attribute import AttrScope
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context,
                      default_device, gpu, num_devices)
from .executor import Executor
from .initializer import init_registry
from .model import FeedForward
from .monitor import Monitor
from .name import NameManager, Prefix
from .random import seed
from .symbol import Group, Variable

__version__ = "0.9.5-torch.5"

__all__ = ["AttrScope", "Context", "Executor", "FeedForward", "Group",
           "MXNetError", "Monitor", "NameManager", "Prefix", "Variable",
           "analysis", "autograd", "base", "callback", "context", "cpu", "cpu_pinned",
           "current_context", "default_device", "engine", "executor", "gpu",
           "init_registry", "initializer", "interop", "io", "kvstore",
           "kvstore_server", "lr_scheduler",
           "metric", "mod", "model", "models", "module", "monitor", "nd",
           "ndarray", "num_devices", "operator", "optimizer", "parallel",
           "predict", "progcache",
           "profiler", "quant", "random", "rnn", "rtc", "seed", "serving",
           "sym", "symbol", "telemetry"]
