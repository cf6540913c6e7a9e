"""Per-request token stream.

Counterpart of ``mxnet_tpu/serving/generate/stream.py``. A ``TokenStream``
is the caller's half of one generate request: tokens appear as the
scheduler decodes them; iteration blocks until the next token or
end-of-stream. Finish is terminal and carries a reason (``"eos"``,
``"max_tokens"``, ``"capacity"`` — the row hit the KV slab capacity) or a
``ServingError`` (deadline, shutdown, cancel, dispatch failure).

``_cond`` is a leaf lock: the scheduler emits tokens holding only it, and
callers never re-enter scheduler code from inside iteration.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional

from ..batcher import ServingError


class TokenStream:
    """Consumer handle for one streaming generate request. ``trace`` is
    the request's trace context (``telemetry.context``): the scheduler
    stamps it on the request's spans and its flight-recorder entry."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 deadline: Optional[float] = None,
                 request_id: Optional[str] = None, trace=None):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline              # time.monotonic() absolute
        self.request_id = request_id          # caller correlation id
        self.trace = trace
        self.submitted = time.monotonic()
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._read = 0
        self._done = False
        self.finish_reason: Optional[str] = None
        self._error: Optional[ServingError] = None
        self._cancelled = False

    # --- scheduler side ---------------------------------------------------
    def _emit(self, token: int):
        with self._cond:
            if self._done:
                return
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, reason: str):
        with self._cond:
            if self._done:
                return
            self._done = True
            self.finish_reason = reason
            self._cond.notify_all()

    def _fail(self, err: ServingError):
        with self._cond:
            if self._done:
                return
            self._done = True
            self.finish_reason = err.code
            self._error = err
            self._cond.notify_all()

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._cancelled

    # --- caller side ------------------------------------------------------
    def cancel(self):
        """Stop decoding this request; the scheduler frees its slot at the
        next step. Already-produced tokens stay readable."""
        with self._cond:
            if not self._done:
                self._cancelled = True

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token id, or None at end of stream. Raises the stream's
        ServingError if it failed, or ``wait_timeout`` on timeout."""
        limit = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._read < len(self._tokens):
                    tok = self._tokens[self._read]
                    self._read += 1
                    return tok
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return None
                rem = None if limit is None else limit - time.monotonic()
                if rem is not None and rem <= 0:
                    raise ServingError("generate stream: no token within "
                                       "timeout", code="wait_timeout")
                self._cond.wait(rem)

    def __iter__(self) -> Iterator[int]:
        while True:
            tok = self.next_token()
            if tok is None:
                return
            yield tok

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; return all generated tokens."""
        limit = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                rem = None if limit is None else limit - time.monotonic()
                if rem is not None and rem <= 0:
                    raise ServingError("generate stream: not finished "
                                       "within timeout", code="wait_timeout")
                self._cond.wait(rem)
            if self._error is not None:
                raise self._error
            return list(self._tokens)

    @property
    def done(self) -> bool:
        with self._cond:
            return self._done
