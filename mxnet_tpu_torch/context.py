"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``. A context is a ``torch.device``:
``gpu(i)`` is CUDA card ``i``, ``cpu()`` the host. ``default_device()`` is
the first card, and raises when there is none — the port never carries on
quietly on the CPU; a caller who wants the CPU asks for it.
"""
from __future__ import annotations

import torch

from .base import MXNetError


def cpu(device_id: int = 0) -> torch.device:
    """The host. ``device_id`` is accepted for reference-style scripts."""
    del device_id
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def default_device() -> torch.device:
    """``cuda:0``; raises MXNetError when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device available; pass device='cpu' to run on the host")
    return gpu(0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`.
    A bare "cuda" names card 0, so devices compare equal to the tensors'
    own."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return gpu(0)
    return device
