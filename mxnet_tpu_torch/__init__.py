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
and the reference's through ``interop``.
"""
from . import (autograd, base, callback, context, engine, executor,
               initializer, interop, io, metric, model, models, module,
               ndarray, operator, optimizer, random, rnn, rtc, symbol)
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import cpu, default_device, gpu

__version__ = "0.9.5-torch.5"

__all__ = ["MXNetError", "autograd", "base", "callback", "context", "cpu",
           "default_device", "engine", "executor", "gpu", "initializer",
           "interop", "io", "metric", "mod", "model", "models", "module",
           "nd", "ndarray", "operator", "optimizer", "random", "rnn", "rtc",
           "sym", "symbol"]
