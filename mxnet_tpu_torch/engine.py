"""Host-side dependency engine (the Python engine only).

Counterpart of ``mxnet_tpu/engine.py``'s ``PythonEngine`` and its module
API (reference: include/mxnet/engine.h). Closures are pushed with the
variables they read (``const_vars``) and write (``mutable_vars``).
``ThreadedEngine`` (the default, ``MXNET_ENGINE_TYPE``) drains a FIFO on one
daemon worker: ops run in push order — conservative, as if every op
conflicted on a variable — but the pushing thread is not blocked.
``NaiveEngine`` runs every op inline.

    from mxnet_tpu_torch import engine
    v = engine.new_variable()
    engine.push(lambda: write_file(...), mutable_vars=[v])
    engine.fence([v]).wait()

Checkpoint files are written through it (:func:`push_file_write`, one
variable a path): ``async_write=True`` returns at once and the write
overlaps training; a reader waits with :func:`wait_for_file`, and a failed
write raises there or at the next file write. The native engine,
capture/replay and trace-and-fuse are not ported yet.
"""
from __future__ import annotations

import os
import queue
import threading
import traceback
from typing import Optional, Sequence

from .base import MXNetError


class PythonEngine:
    """Inline (``NaiveEngine``) or one-worker FIFO (``ThreadedEngine``)."""

    def __init__(self, engine_type: str = "NaiveEngine"):
        self._next = 1
        self._var_lock = threading.Lock()
        self._queue: Optional[queue.Queue] = None
        if engine_type != "NaiveEngine":
            self._queue = queue.Queue()
            threading.Thread(target=self._worker, daemon=True,
                             name="mxtt-py-engine").start()

    def _worker(self):
        while True:
            fn = self._queue.get()
            try:
                fn()
            except Exception:  # never kill the worker loop
                traceback.print_exc()
            finally:
                self._queue.task_done()

    def new_variable(self) -> int:
        with self._var_lock:
            self._next += 1
            return self._next - 1

    def delete_variable(self, var):
        pass

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name="op"):
        if self._queue is not None:
            self._queue.put(fn)
            return
        try:
            fn()
        except Exception:  # same contract as the worker: report, go on
            traceback.print_exc()

    def wait_for_var(self, var):
        # the FIFO admits no reordering, so draining it is a correct (if
        # coarse) WaitForVar
        if self._queue is not None:
            self._queue.join()

    def wait_for_all(self):
        if self._queue is not None:
            self._queue.join()


_engine: Optional[PythonEngine] = None
_engine_lock = threading.Lock()


def get() -> PythonEngine:
    """Engine singleton; type from MXNET_ENGINE_TYPE (ThreadedEngine)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = PythonEngine(
                os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine"))
        return _engine


def new_variable() -> int:
    return get().new_variable()


def delete_variable(var):
    get().delete_variable(var)


def track_inflight(var):
    """No-op: in-flight accounting belongs to the native engine, which is
    not ported yet."""
    del var


def push(fn, const_vars=(), mutable_vars=(), priority=0, name="op"):
    get().push(fn, const_vars, mutable_vars, priority, name)


def wait_for_var(var):
    get().wait_for_var(var)


def wait_for_all():
    get().wait_for_all()


class Fence:
    """Handle returned by :func:`fence` — a pushed barrier op. ``wait()``
    blocks until every op enqueued before the fence on the fenced vars has
    completed."""

    def __init__(self, event: threading.Event, n_vars: int):
        self._event = event
        self.n_vars = n_vars

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> "Fence":
        """Block for the barrier; raises MXNetError on timeout."""
        if not self._event.wait(timeout):
            raise MXNetError(
                "engine fence over %d var(s) not reached after %.3fs"
                % (self.n_vars, timeout))
        return self


def fence(vars: Sequence[int], priority: int = 0,
          name: str = "fence") -> Fence:
    """Push a barrier op that reads every var in ``vars``; it runs once all
    prior writers of those vars have completed."""
    ev = threading.Event()
    vs = list(vars)
    get().push(ev.set, const_vars=vs, priority=priority, name=name)
    return Fence(ev, len(vs))


# --- checkpoint file writes (reference: every store goes through the engine)
_file_lock = threading.Lock()
_file_vars = {}   # absolute path -> engine variable
_file_errs = {}   # absolute path -> the exception its last write raised


def push_file_write(path: str, fn, wait: bool = True,
                    name: Optional[str] = None):
    """Run ``fn`` (which writes ``path``) as an engine op holding the
    path's variable; ``wait=False`` returns at once. A failed write
    raises at the next :func:`wait_for_file` of its path, or at the next
    file write of any path (per-epoch files have distinct names, so a
    full disk must not stay silent)."""
    apath = os.path.abspath(path)
    _raise_pending_file_error()
    with _file_lock:
        var = _file_vars.get(apath)
        if var is None:
            var = _file_vars[apath] = new_variable()

    def run():
        try:
            fn()
        except Exception as e:  # raised at the next sync point
            with _file_lock:
                _file_errs[apath] = e

    push(run, mutable_vars=[var],
         name=name or "file_write:%s" % os.path.basename(apath))
    if wait:
        wait_for_file(apath)


def _raise_pending_file_error():
    with _file_lock:
        if not _file_errs:
            return
        path = next(iter(_file_errs))
        err = _file_errs.pop(path)
    raise err


def wait_for_file(path: str):
    """Block until every write pushed for ``path`` has run; raise the
    failure of one, if any."""
    apath = os.path.abspath(path)
    with _file_lock:
        var = _file_vars.get(apath)
    if var is not None:
        wait_for_var(var)
    with _file_lock:
        err = _file_errs.pop(apath, None)
    if err is not None:
        raise err
