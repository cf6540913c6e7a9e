"""Structured serving failures.

Counterpart of ``mxnet_tpu/serving/batcher.py``'s ``ServingError`` (the
batch former itself is not ported yet). Every way a request can fail
carries a machine-readable ``code``:

- ``queue_full``         the bounded queue rejected the submit
- ``too_large``          the request can never be served (prompt too long)
- ``deadline_exceeded``  the request expired
- ``shutdown``           the server stopped while the request was queued
- ``shutting_down``      the server is draining; new submits are refused
- ``dispatch_error``     a device program raised; the request carries it
- ``wait_timeout``       a caller's wait on a stream gave up
- ``cancelled``          the caller cancelled an in-flight generate stream
- ``not_ported``         the option exists in the reference but not here yet
"""
from __future__ import annotations

from ..base import MXNetError


class ServingError(MXNetError):
    """Structured serving failure; ``code`` is machine-readable."""

    def __init__(self, msg: str, code: str = "error"):
        super().__init__(msg)
        self.code = code
