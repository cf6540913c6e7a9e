"""Base utilities: the framework's error type.

Counterpart of ``mxnet_tpu/base.py`` (reference: python/mxnet/base.py:71).
"""
from __future__ import annotations


class MXNetError(RuntimeError):
    """Error raised by the framework."""
