"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``. A context is a ``torch.device``:
``gpu(i)`` is CUDA card ``i``, ``cpu()`` (and ``cpu_pinned()``: pinning is
the allocator's business here) the host. ``default_device()`` is the first
card, and raises when there is none — the port never carries on quietly
on the CPU; a caller who wants the CPU asks for it.

:class:`Context` is the reference's class, for scripts that name devices
by type and id: it resolves to a ``torch.device``, and ``with
Context(...)`` makes it the device of calls that name none, as the
reference's ``with mx.cpu():`` does. ``mx.tpu`` has no counterpart; the
port's accelerator context is ``gpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

_scope = threading.local()


class Context:
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return gpu(self.device_id)
        return cpu()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old = getattr(_scope, "ctx", None)
        _scope.ctx = self
        return self

    def __exit__(self, ptype, value, trace):
        _scope.ctx = self._old


def cpu(device_id: int = 0) -> torch.device:
    """The host. ``device_id`` is accepted for reference-style scripts."""
    del device_id
    return torch.device("cpu")


def cpu_pinned(device_id: int = 0) -> torch.device:
    """The host (the reference's page-locked host context)."""
    return cpu(device_id)


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def num_devices(kind=None) -> int:
    """The CUDA cards (``kind`` None or "gpu"), or 1 host."""
    if kind in (None, "gpu"):
        return torch.cuda.device_count()
    return 1


def current_context() -> Context:
    """The ``with Context(...)`` in force, else the first card."""
    return getattr(_scope, "ctx", None) or Context("gpu", 0)


def default_device() -> torch.device:
    """``cuda:0``; raises MXNetError when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device available; pass device='cpu' to run on the host")
    return gpu(0)


def resolve_device(device=None) -> torch.device:
    """``device`` (a torch device, its name or a :class:`Context`) as a
    torch.device; None means the ``with Context(...)`` in force, else
    :func:`default_device`. A bare "cuda" names card 0, so devices compare
    equal to the tensors' own."""
    if device is None:
        device = getattr(_scope, "ctx", None)
        if device is None:
            return default_device()
    if isinstance(device, Context):
        return device.torch_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return gpu(0)
    return device


def prepare_capture_thread(device, stream) -> None:
    """Create the calling thread's cuDNN and cuBLAS handles on ``device``
    (and cuBLAS's workspace for ``stream``) outside a CUDA graph capture.

    The libraries make a handle a thread at first use, and making one
    allocates device memory, which a capture refuses: a graph captured on
    a thread that never ran a convolution or a product (an engine worker
    capturing a step that warmed up on other workers) would fail. Three
    tiny operations on ``stream`` make them first; they launch none of the
    port's kernels."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        a = torch.ones((8, 8), device=device)
        a @ a
        a.bfloat16() @ a.bfloat16()
        torch.nn.functional.conv2d(a.view(1, 1, 8, 8),
                                   a[:3, :3].reshape(1, 1, 3, 3))
