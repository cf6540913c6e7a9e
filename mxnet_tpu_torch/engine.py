"""Host-side dependency engine.

Counterpart of ``mxnet_tpu/engine.py`` (reference: include/mxnet/engine.h,
src/engine/threaded_engine*.cc). Closures are pushed with the variables
they read (``const_vars``) and write (``mutable_vars``); conflicting ops
serialize in push order, independent ops run concurrently.

Device work is ordered by CUDA streams and graphs; this engine orders the
host work they cannot see: checkpoint files, the prefetching iterator, the
parameter server's RPCs, the serving dispatch and retunes, the decode
steps. ``engine.get()`` follows ``MXNET_ENGINE_TYPE``: ``ThreadedEngine``
(the default) is :class:`NativeEngine`, the port's own copy of the native
scheduler (``native/engine.cc``, built with ``g++`` at first use into
``_build/``, its C symbols ``mxtt_engine_*``) on a worker pool
(``MXNET_CPU_WORKER_NTHREADS``, default half the cores, at most 8);
``NaiveEngine`` runs every op inline. Where the library cannot be built the
engine is :class:`PythonEngine` (one FIFO worker), as in the reference.

    from mxnet_tpu_torch import engine
    v = engine.new_variable()
    engine.push(lambda: write_file(...), mutable_vars=[v])
    engine.fence([v]).wait()

Checkpoint files are written through it (:func:`push_file_write`, one
variable a path). A variable registered with :func:`track_inflight` has
every push that names it counted until the op completes
(:func:`var_inflight`, the serving router's signal).

Capture/replay (``MXNET_ENGINE_CAPTURE``, :class:`CapturedSequence`): a
steady-state push sequence is recorded for ``MXNET_ENGINE_CAPTURE_WARMUP``
iterations (default 3, floor 2), compiled to a static RAW / WAR / WAW edge
list, then each iteration is ONE ``push_async`` that runs the recorded
closures in order. Host code only: it adds no device synchronize.

Trace-and-fuse (``MXNET_ENGINE_FUSE``, :class:`FuseOp`,
:class:`FusedSequence`): a stable sequence whose every op carries a
:class:`FuseOp` is stitched into one torch function over registers keyed
by engine var. Where its registers live on a card, that function is
captured as ONE CUDA graph over static carry buffers, updated in place,
and each iteration copies its feeds into static buffers and replays the
graph (the launch counters add each replay's launches); on the CPU it runs
eagerly. Feed drift bails the iteration to replay.

The happens-before sanitizer (``MXNET_ENGINE_SANITIZER=1`` or
:func:`sanitizer_enable`) checks every push against shadow epochs of
host state registered with :func:`guard_state`, and every replay against
the conflicts of its recorded ops.

Telemetry (domain ``engine``, as the reference's): each op runs inside a
span named for the op, with its queue wait (``queue_us``) and its variable
lists; :func:`wait_for_all`, :meth:`Fence.wait`, ``engine.replay`` and
``engine.fused_run`` are spans of their own; the registry's
``engine_pending_ops`` gauge reads the queue's depth and never creates an
engine.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import logging
import os
import queue
import threading
import traceback
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import telemetry as _telemetry
from .base import MXNetError

_log = logging.getLogger("mxnet_tpu_torch")

_OPR_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)
_DEL_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

#: the native scheduler's source, built at first use
NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "native", "engine.cc")

# --- op-error observation ----------------------------------------------------
# An op's exception never escapes the worker (it would cross the C boundary
# or kill the worker loop): it is printed, and a process-wide handler may
# observe it.
_op_error_handler: Optional[Callable[[str, BaseException], None]] = None


def set_error_handler(fn: Optional[Callable[[str, BaseException], None]]):
    """Install ``fn(op_name, exc)`` to observe engine-op exceptions (which
    are otherwise only printed); ``None`` resets. Returns the previous
    handler. It runs on the engine worker and must not raise."""
    global _op_error_handler
    prev = _op_error_handler
    _op_error_handler = fn
    return prev


def _notify_op_error(name: str, exc: BaseException):
    h = _op_error_handler
    if h is not None:
        try:
            h(name, exc)
        except Exception:  # an observing hook must never break dispatch
            traceback.print_exc()


# --- the native engine -------------------------------------------------------
_native_lock = threading.Lock()
_native_lib: List[ctypes.CDLL] = []


def _load_native() -> ctypes.CDLL:
    """The native scheduler's library, built first if needed; raises
    MXNetError when it cannot be built or loaded."""
    with _native_lock:
        if _native_lib:
            return _native_lib[0]
        from .ops.kernels import _build

        path = _build.build_host("mxtt_engine", NATIVE_SRC)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise MXNetError("native engine library %s: %s" % (path, e))
        lib.mxtt_engine_create.restype = ctypes.c_void_p
        lib.mxtt_engine_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mxtt_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.mxtt_engine_new_var.restype = ctypes.c_int64
        lib.mxtt_engine_new_var.argtypes = [ctypes.c_void_p]
        lib.mxtt_engine_delete_var.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64]
        lib.mxtt_engine_push.argtypes = [
            ctypes.c_void_p, _OPR_FN, ctypes.c_void_p, _DEL_FN,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.mxtt_engine_opr_complete.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_void_p]
        lib.mxtt_engine_wait_for_var.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int64]
        lib.mxtt_engine_wait_for_all.argtypes = [ctypes.c_void_p]
        lib.mxtt_engine_pending.restype = ctypes.c_int
        lib.mxtt_engine_pending.argtypes = [ctypes.c_void_p]
        lib.mxtt_engine_set_profiling.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
        lib.mxtt_engine_dump_profile.restype = ctypes.c_int64
        lib.mxtt_engine_dump_profile.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        _native_lib.append(lib)
        return lib


class NativeEngine:
    """ctypes wrapper over ``native/engine.cc`` (``ThreadedEngine``: a
    worker pool; ``NaiveEngine``: every op inline in ``push``)."""

    def __init__(self, num_workers=0, engine_type="ThreadedEngine"):
        self._lib = _load_native()
        self.engine_type = engine_type
        etype = 1 if engine_type == "NaiveEngine" else 0
        self._h = self._lib.mxtt_engine_create(num_workers, etype)
        self._pending: Dict[int, tuple] = {}
        self._pending_lock = threading.Lock()
        self._next_key = [1]
        # one C trampoline for every op; param = key into _pending
        self._trampoline = _OPR_FN(self._dispatch)
        self._no_del = ctypes.cast(None, _DEL_FN)

    def _dispatch(self, param, on_complete):
        key = int(param)
        with self._pending_lock:
            fn, is_async, name, t_q, const_vars, mutable_vars = \
                self._pending.pop(key)
        span_args = None
        if t_q and _telemetry.enabled("engine"):
            span_args = {"queue_us": (_telemetry.clock_ns() - t_q) // 1000,
                         "const_vars": list(const_vars),
                         "mutable_vars": list(mutable_vars)}
        tok = None
        try:
            if is_async:
                h = ctypes.c_void_p(on_complete)
                if span_args is not None:
                    tok = _telemetry.begin(name, domain="engine", **span_args)

                def complete(_h=h, _tok=tok):
                    _telemetry.end(_tok)
                    self._lib.mxtt_engine_opr_complete(self._h, _h)

                fn(complete)
            else:
                if span_args is not None:
                    with _telemetry.span(name, domain="engine", **span_args):
                        fn()
                else:
                    fn()
        except Exception as e:  # never let an exception cross the C boundary
            traceback.print_exc()
            _notify_op_error(name, e)
            if is_async:
                _telemetry.end(tok, error=True)
                self._lib.mxtt_engine_opr_complete(
                    self._h, ctypes.c_void_p(on_complete))
        finally:
            # drop the op now: its closure (a server, its graphs) must not
            # live until the next push
            fn = None

    def new_variable(self) -> int:
        return self._lib.mxtt_engine_new_var(self._h)

    def delete_variable(self, var: int):
        self._lib.mxtt_engine_delete_var(self._h, var)

    def _push(self, fn, const_vars, mutable_vars, priority, name, is_async):
        const_vars, mutable_vars = _dedup(const_vars, mutable_vars)
        t_q = _telemetry.clock_ns() if _telemetry.enabled("engine") else 0
        with self._pending_lock:
            key = self._next_key[0]
            self._next_key[0] += 1
            self._pending[key] = (fn, is_async, name, t_q,
                                  tuple(const_vars), tuple(mutable_vars))
        c = (ctypes.c_int64 * max(len(const_vars), 1))(*const_vars)
        m = (ctypes.c_int64 * max(len(mutable_vars), 1))(*mutable_vars)
        self._lib.mxtt_engine_push(self._h, self._trampoline,
                                   ctypes.c_void_p(key), self._no_del, c,
                                   len(const_vars), m, len(mutable_vars),
                                   priority, name.encode(),
                                   1 if is_async else 0)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name="op"):
        """PushSync: ``fn`` runs on a worker; it completes on return."""
        self._push(fn, const_vars, mutable_vars, priority, name, False)

    def push_async(self, fn, const_vars=(), mutable_vars=(), priority=0,
                   name="op"):
        """PushAsync: ``fn(on_complete)`` must call ``on_complete`` (from
        any thread) when the op is done."""
        self._push(fn, const_vars, mutable_vars, priority, name, True)

    def wait_for_var(self, var: int):
        self._lib.mxtt_engine_wait_for_var(self._h, var)

    def wait_for_all(self):
        self._lib.mxtt_engine_wait_for_all(self._h)

    def pending(self) -> int:
        """Ops queued or running."""
        return self._lib.mxtt_engine_pending(self._h)

    def set_profiling(self, on: bool):
        self._lib.mxtt_engine_set_profiling(self._h, int(on))

    def dump_profile(self) -> dict:
        n = self._lib.mxtt_engine_dump_profile(self._h, None, 0)
        buf = ctypes.create_string_buffer(n + 16)
        self._lib.mxtt_engine_dump_profile(self._h, buf, n + 16)
        return json.loads(buf.value.decode())


class PythonEngine:
    """The fallback where the native library cannot be built: inline
    (``NaiveEngine``) or one FIFO worker (``ThreadedEngine``: ops run in
    push order, as if every op conflicted, but the pusher is not
    blocked)."""

    def __init__(self, num_workers=0, engine_type="NaiveEngine"):
        del num_workers
        self.engine_type = engine_type
        self._next = 1
        self._var_lock = threading.Lock()
        self._queue: Optional[queue.Queue] = None
        if engine_type != "NaiveEngine":
            self._queue = queue.Queue()
            threading.Thread(target=self._worker, daemon=True,
                             name="mxtt-py-engine").start()

    def _worker(self):
        while True:
            fn, name = self._queue.get()
            try:
                fn()
            except Exception as e:  # never kill the worker loop
                traceback.print_exc()
                _notify_op_error(name, e)
            finally:
                fn = None
                self._queue.task_done()

    @staticmethod
    def _traced(fn, name, const_vars, mutable_vars):
        """``fn`` inside its engine-domain span, or ``fn`` itself when the
        domain is off at push time (the span's queue wait starts there)."""
        if not _telemetry.enabled("engine"):
            return fn
        t_q = _telemetry.clock_ns()
        const_vars, mutable_vars = list(const_vars), list(mutable_vars)

        def run():
            with _telemetry.span(
                    name, domain="engine",
                    queue_us=(_telemetry.clock_ns() - t_q) // 1000,
                    const_vars=const_vars, mutable_vars=mutable_vars):
                fn()
        return run

    def new_variable(self) -> int:
        with self._var_lock:
            self._next += 1
            return self._next - 1

    def delete_variable(self, var):
        pass

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             name="op"):
        self._run(self._traced(fn, name, const_vars, mutable_vars), name)

    def push_async(self, fn, const_vars=(), mutable_vars=(), priority=0,
                   name="op"):
        def run():
            done = threading.Event()
            fn(done.set)
            done.wait()  # hold the FIFO slot until on_complete fires

        self._run(self._traced(run, name, const_vars, mutable_vars), name)

    def _run(self, fn, name):
        if self._queue is not None:
            self._queue.put((fn, name))
            return
        try:
            fn()
        except Exception as e:  # same contract as the worker: report, go on
            traceback.print_exc()
            _notify_op_error(name, e)

    def wait_for_var(self, var):
        # the FIFO admits no reordering: draining it is a (coarse) WaitForVar
        if self._queue is not None:
            self._queue.join()

    def wait_for_all(self):
        if self._queue is not None:
            self._queue.join()

    def pending(self) -> int:
        return self._queue.unfinished_tasks if self._queue is not None else 0


def _dedup(const_vars, mutable_vars):
    """DeduplicateVarHandle (engine.h:231-249): drop repeats; a var both
    read and written is tracked as mutable only."""
    mut = list(dict.fromkeys(mutable_vars))
    mset = set(mut)
    const = [v for v in dict.fromkeys(const_vars) if v not in mset]
    return const, mut


_engine = None
_engine_lock = threading.Lock()


def get() -> "NativeEngine | PythonEngine":
    """Engine singleton; type from MXNET_ENGINE_TYPE (ThreadedEngine)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            etype = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEngine")
            workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "0"))
            try:
                _engine = NativeEngine(workers, etype)
            except MXNetError as e:
                _log.warning("native engine unavailable (%s): the Python "
                             "engine runs instead", e)
                _engine = PythonEngine(workers, etype)
        return _engine


def new_variable() -> int:
    v = get().new_variable()
    if _san is not None:
        _san.on_new(v)
    return v


def delete_variable(var):
    if _san is not None:
        _san.on_delete(var)
    get().delete_variable(var)


def push(fn, const_vars=(), mutable_vars=(), priority=0, name="op"):
    if _san is not None:
        _san.on_push(fn, const_vars, mutable_vars, name)
    counted = _inflight_begin(tuple(const_vars) + tuple(mutable_vars))
    if counted:
        fn = _wrap_inflight_sync(fn, counted)
    get().push(fn, const_vars, mutable_vars, priority, name)


def push_async(fn, const_vars=(), mutable_vars=(), priority=0, name="op"):
    """Push ``fn(on_complete)``: the op holds its variables until
    ``on_complete`` is called."""
    if _san is not None:
        _san.on_push(fn, const_vars, mutable_vars, name)
    counted = _inflight_begin(tuple(const_vars) + tuple(mutable_vars))
    if counted:
        fn = _wrap_inflight_async(fn, counted)
    get().push_async(fn, const_vars, mutable_vars, priority, name)


def wait_for_var(var):
    get().wait_for_var(var)
    if _san is not None:
        _san.on_sync((int(var),))


def wait_for_all():
    with _telemetry.span("engine.wait_for_all", domain="engine"):
        get().wait_for_all()
    if _san is not None:
        _san.on_sync(None)
    _raise_pending_file_error()


class Fence:
    """Handle returned by :func:`fence` — a pushed barrier op. ``wait()``
    blocks until every op enqueued before the fence on the fenced vars has
    completed, async ops included (their ``on_complete`` fired)."""

    def __init__(self, event: threading.Event, n_vars: int,
                 fence_vars: Sequence[int] = ()):
        self._event = event
        self.n_vars = n_vars
        self._fence_vars = tuple(fence_vars)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> "Fence":
        """Block for the barrier; raises MXNetError on timeout."""
        with _telemetry.span("engine.fence.wait", domain="engine",
                             n_vars=self.n_vars):
            reached = self._event.wait(timeout)
        if not reached:
            raise MXNetError(
                "engine fence over %d var(s) not reached after %.3fs"
                % (self.n_vars, timeout))
        if _san is not None and self._fence_vars:
            _san.on_sync(self._fence_vars)
        return self


def fence(vars: Sequence[int], priority: int = 0,
          name: str = "fence") -> Fence:
    """Push a barrier op that reads every var in ``vars``; it runs once all
    prior writers of those vars have completed."""
    ev = threading.Event()
    vs = list(vars)
    if _san is not None:
        _san.on_fence(vs, name)
    get().push(ev.set, const_vars=vs, priority=priority, name=name)
    return Fence(ev, len(vs), fence_vars=vs)


# --- capture/replay of steady-state dispatch sequences -----------------------
def _env_on(name: str) -> bool:
    return os.environ.get(name, "0").lower() not in ("0", "", "false", "off")


def capture_enabled() -> bool:
    """True when ``MXNET_ENGINE_CAPTURE`` opts steady-state callers
    (``Module.fit_step``, the serving dispatch, the decode scheduler) into
    capture/replay. Read at the point of use."""
    return _env_on("MXNET_ENGINE_CAPTURE")


def capture_warmup() -> int:
    """Warm-up iterations before a sequence may replay
    (``MXNET_ENGINE_CAPTURE_WARMUP``, default 3, floor 2)."""
    try:
        n = int(os.environ.get("MXNET_ENGINE_CAPTURE_WARMUP", "3"))
    except ValueError:
        n = 3
    return max(2, n)


def fuse_enabled() -> bool:
    """True when ``MXNET_ENGINE_FUSE`` opts stable captured sequences into
    trace-and-fuse (one stitched function, one CUDA graph on a card).
    Read at the point of use."""
    return _env_on("MXNET_ENGINE_FUSE")


class _FuseBail(Exception):
    """Per-iteration fuse bail (feed drift, a failure before any side
    effect): the iteration falls back to replay."""


class _FuseIneligible(Exception):
    """The recorded sequence cannot be fused at all."""


class FuseOp:
    """Traceable metadata for one captured push (trace-and-fuse).

    - ``fn(*registers, *feeds) -> tuple(out registers)``: torch code over
      the op's ``in_vars``' registers (in order) and its feed values,
      producing one register per ``out_vars`` entry. Registers are trees
      (dicts, lists, tuples) of tensors keyed by engine var. On a card the
      stitched ops are captured as one CUDA graph, so ``fn`` must be
      capturable: no host sync, no host read of a device value.
    - ``in_vars`` / ``out_vars``: covered by the push's declared const /
      mutable sets.
    - ``feed``: the iteration's inputs — a tuple, or a zero-arg callable
      returning one (run inside the fused engine op). Shapes, types and
      devices must stay as staged; drift bails the iteration to replay.
    - ``init``: var -> value or zero-arg callable seeding a register read
      before it is written (live-in), evaluated once at staging, after a
      quiescing fence.
    - ``writeback``: host callable receiving ``{var: final value}`` for the
      op's out_vars after each fused iteration.
    - ``fingerprint``: a stable description of the computation for the
      sequence's signature; None hashes the op's code object.
    - ``device``: the device ``fn`` computes on, where no register or feed
      tensor lies there (a forward fed from host staging buffers).
    """

    __slots__ = ("fn", "in_vars", "out_vars", "feed", "init", "writeback",
                 "fingerprint", "device")

    def __init__(self, fn, in_vars: Sequence[int] = (),
                 out_vars: Sequence[int] = (), feed=(), init=None,
                 writeback=None, fingerprint: Optional[str] = None,
                 device=None):
        self.fn = fn
        self.in_vars = tuple(int(v) for v in in_vars)
        self.out_vars = tuple(int(v) for v in out_vars)
        self.feed = feed
        self.init = init or {}
        self.writeback = writeback
        self.fingerprint = fingerprint
        self.device = device


# process-wide trace-and-fuse accounting: the dict is the test surface, the
# registry counters the telemetry export. ``compiles`` counts stagings (a
# stitch of the recorded ops), ``captures`` the CUDA graphs captured of
# them; ``disk_loads`` stays 0 (the fused kind has no program-cache entry)
_fuse_stats = {"runs": 0, "bails": 0, "ineligible": 0, "compiles": 0,
               "disk_loads": 0, "captures": 0}
_fused_runs_counter = _telemetry.registry.counter(
    "engine_fused_runs_total",
    help="captured-sequence iterations executed as one fused program")
_fuse_bails_counter = _telemetry.registry.counter(
    "engine_fuse_bails_total",
    help="trace-and-fuse bails back to replay (ineligible sequence, "
         "staging failure, feed drift, runtime error)")


def fused_stats() -> Dict[str, int]:
    """Snapshot of the trace-and-fuse counters since process start or the
    last reset."""
    return dict(_fuse_stats)


def fused_stats_reset():
    for k in _fuse_stats:
        _fuse_stats[k] = 0


def _count_fuse_bail(kind: str):
    _fuse_stats["bails"] += 1
    if kind == "ineligible":
        _fuse_stats["ineligible"] += 1
    _fuse_bails_counter.inc()


def _tree_flatten(tree):
    """(leaves, structure) of a tree of dicts, lists and tuples; anything
    else is a leaf. :func:`_tree_unflatten` inverts it."""
    if isinstance(tree, dict):
        parts = [_tree_flatten(tree[k]) for k in tree]
        return ([x for p in parts for x in p[0]],
                ("dict", tuple(tree), tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_tree_flatten(x) for x in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, len(tree),
                 tuple(p[1] for p in parts)))
    return [tree], "leaf"


def _tree_unflatten(leaves, struct):
    it = iter(leaves)

    def build(st):
        if st == "leaf":
            return next(it)
        if st[0] == "dict":
            return {k: build(sub) for k, sub in zip(st[1], st[2])}
        items = [build(sub) for sub in st[2]]
        return items if st[0] == "list" else tuple(items)

    return build(struct)


def _aval(leaf):
    """(shape, dtype, device) of a tensor or array leaf; any other leaf is
    its own value (a constant of the staged program)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), leaf.device.type,
                leaf.device.index)
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return (tuple(leaf.shape), str(leaf.dtype), "host", None)
    return ("value", repr(leaf))


class FusedSequence:
    """One stable :class:`CapturedSequence` stitched into one program
    (``MXNET_ENGINE_FUSE``).

    Staging runs on the sequence's driving thread at the first ready
    ``end_step``:

    1. **Quiesce**: fence the union var set so every warm-up iteration's
       effects are settled before live-in registers are seeded.
    2. **Liveness** over the per-op ``in_vars`` / ``out_vars``: a var read
       before its first write is *carried* (live-in and live-out, seeded
       from ``FuseOp.init``); one written first is an *intermediate*,
       materialized only where a writeback reads it. Var ids are
       normalized to sequence-local indices.
    3. **Stitch**: each op's ``fn`` runs in recorded order, consuming
       registers along the pre-resolved edges, in one function
       ``(carry, feeds) -> (mats, carry')``.

    Each iteration (:meth:`run_iteration`, on the engine worker inside the
    one ``fused:<name>`` push) evaluates the feeds and checks them against
    the staged ones (drift raises :class:`_FuseBail` before anything runs),
    runs the program and the writebacks. On a card (a register or feed
    tensor on CUDA) the first iteration captures the stitched function as
    ONE CUDA graph over the carried registers' own tensors (each leaf the
    step does not update in place is copied back into its buffer inside the
    graph) and static feed buffers (pinned host memory for host feeds, so
    their host-to-device copies run inside the graph); every iteration
    copies its feeds into those buffers and replays. On the CPU the
    function runs eagerly.
    """

    def __init__(self, name: str, ops: List[tuple], fuses: List[FuseOp],
                 union: Tuple[tuple, tuple]):
        import torch

        self.name = name
        u_const, u_mut = union
        # 1. quiesce: warm-up iterations still in flight wrote the state
        # the init callables are about to read
        fence(list(u_const) + list(u_mut),
              name="fuse_stage:%s" % name).wait(120)
        declared_mut = [set(int(v) for v in sig[4]) for sig, _ in ops]
        declared_all = [set(int(v) for v in sig[3]) | declared_mut[i]
                        for i, (sig, _) in enumerate(ops)]
        for i, f in enumerate(fuses):
            if not set(f.in_vars) <= declared_all[i]:
                raise _FuseIneligible(
                    "op %d (%s) fuse metadata reads vars outside its "
                    "declared set" % (i, ops[i][0][1]))
            if not set(f.out_vars) <= declared_mut[i]:
                raise _FuseIneligible(
                    "op %d (%s) fuse metadata writes vars outside its "
                    "declared mutable set" % (i, ops[i][0][1]))
        # 2. liveness under normalized (process-independent) var indices
        var_idx: Dict[int, int] = {}
        for v in list(u_const) + list(u_mut):
            var_idx[int(v)] = len(var_idx)
        first: Dict[int, str] = {}
        order: List[int] = []
        for f in fuses:
            for v in f.in_vars:
                if v not in first:
                    first[v] = "r"
                    order.append(v)
            for v in f.out_vars:
                if v not in first:
                    first[v] = "w"
                    order.append(v)
        carried = tuple(v for v in order if first[v] == "r")
        wb_ops = tuple(i for i, f in enumerate(fuses)
                       if f.writeback is not None)
        mat_vars = tuple(v for i in wb_ops for v in fuses[i].out_vars
                         if v not in carried)
        carry0 = {}
        for v in carried:
            src = None
            for f in fuses:
                if v in f.init:
                    src = f.init[v]
                    break
            if src is None:
                raise _FuseIneligible(
                    "live-in var %d has no FuseOp.init seed" % v)
            carry0[var_idx[v]] = src() if callable(src) else src
        self._var_idx = var_idx
        self._carried_idx = tuple(var_idx[v] for v in carried)
        self._mat_idx = tuple(sorted(var_idx[v] for v in set(mat_vars)))
        self._wb_ops = wb_ops
        in_idx = tuple(tuple(var_idx[v] for v in f.in_vars) for f in fuses)
        out_idx = tuple(tuple(var_idx[v] for v in f.out_vars)
                        for f in fuses)
        self._out_vars = tuple(f.out_vars for f in fuses)
        # the staged feeds: evaluated once here (the reference values of
        # the drift check), consumed by the first iteration
        feeds0, defs, avals = [], [], []
        for f in fuses:
            fv = tuple(f.feed()) if callable(f.feed) else tuple(f.feed)
            leaves, struct = _tree_flatten(fv)
            feeds0.append(fv)
            defs.append(struct)
            avals.append(tuple(_aval(x) for x in leaves))
        self._feed_defs = tuple(defs)
        self._feed_avals = tuple(avals)
        self._pending_feeds: Optional[tuple] = tuple(feeds0)
        fns = tuple(f.fn for f in fuses)
        carried_idx, mat_idx = self._carried_idx, self._mat_idx
        names = tuple(sig[1] for sig, _ in ops)

        def fused(carry, feeds):
            regs = dict(carry)
            for i, fn in enumerate(fns):
                res = fn(*[regs[k] for k in in_idx[i]], *feeds[i])
                if not isinstance(res, (tuple, list)):
                    res = (res,)
                if len(res) != len(out_idx[i]):
                    raise _FuseIneligible(
                        "op %d (%s) fn returned %d value(s) for %d out "
                        "var(s)" % (i, names[i], len(res), len(out_idx[i])))
                for k, val in zip(out_idx[i], res):
                    regs[k] = val
            return ({k: regs[k] for k in mat_idx},
                    {k: regs[k] for k in carried_idx})

        self._fused = fused
        # the signature: the recorded ops, their fingerprints (or code),
        # edges and register / feed avals, under normalized indices
        sigparts = []
        for i, (sig, deps) in enumerate(ops):
            fp = fuses[i].fingerprint
            if fp is None:
                code = getattr(fns[i], "__code__", None)
                fp = "%s:%s" % (getattr(code, "co_filename", ""),
                                getattr(code, "co_firstlineno", ""))
            sigparts.append((sig[1], sig[0], fp, in_idx[i], out_idx[i],
                             deps, avals[i]))
        carry_leaves = {k: _tree_flatten(carry0[k]) for k in carry0}
        carry_avals = tuple((k, tuple(_aval(x) for x in carry_leaves[k][0]))
                            for k in sorted(carry0))
        self.signature = hashlib.sha1(
            repr((sigparts, carry_avals)).encode()).hexdigest()
        devices = [x.device for k in carry_leaves for x in carry_leaves[k][0]
                   if isinstance(x, torch.Tensor) and x.is_cuda]
        devices += [x.device for fv in feeds0 for x in _tree_flatten(fv)[0]
                    if isinstance(x, torch.Tensor) and x.is_cuda]
        devices += [torch.device(f.device) for f in fuses
                    if f.device is not None
                    and torch.device(f.device).type == "cuda"]
        self.device = devices[0] if devices else None
        self._carry = carry0
        self._graph = None
        self._san_seen = None
        #: iterations run fused, and graph replays among them (on a card)
        self.runs = 0
        self.replays = 0
        _fuse_stats["compiles"] += 1
        from .analysis import compile_witness as _witness
        _witness.record_compile("fused", key=self.signature[:16])
        _log.info("engine fuse '%s': staged %d op(s) into one program "
                  "(%d live-in, %d materialized, %s, signature %s…)", name,
                  len(ops), len(carried), len(mat_vars),
                  "one CUDA graph" if self.device is not None else "eager",
                  self.signature[:12])

    def _eval_feeds(self, fuses) -> tuple:
        vals = []
        for i, f in enumerate(fuses):
            fv = tuple(f.feed()) if callable(f.feed) else tuple(f.feed)
            leaves, struct = _tree_flatten(fv)
            if struct != self._feed_defs[i] or \
                    tuple(_aval(x) for x in leaves) != self._feed_avals[i]:
                raise _FuseBail(
                    "feed for op %d drifted from the staged shapes/dtypes"
                    % i)
            vals.append(fv)
        return tuple(vals)

    def san_check(self, ops):
        """Sanitizer validation: the declared edge set (transitively, with
        program order inside the one fused push) must dominate the full
        conflict-predecessor map."""
        san = _san
        if san is None or self._san_seen is san:
            return
        self._san_seen = san
        conf = _Sanitizer.replay_conflicts(ops)
        reach: List[set] = []
        for i, (_sig, deps) in enumerate(ops):
            r = set(deps)
            for d in deps:
                r |= reach[d]
            reach.append(r)
        for i, cset in enumerate(conf):
            for j in cset:
                if j not in reach[i]:
                    sig_i, sig_j = ops[i][0], ops[j][0]
                    shared = sorted(
                        ({int(v) for v in sig_i[3]}
                         | {int(v) for v in sig_i[4]})
                        & ({int(v) for v in sig_j[3]}
                           | {int(v) for v in sig_j[4]}))
                    san._emit(san._mk(
                        "fused-edge-violation",
                        shared[0] if shared else -1, sig_i[1],
                        "%s[%d]" % (self.name, i), sig_j[1],
                        "%s[%d]" % (self.name, j),
                        detail="fused program's declared edge set does "
                               "not dominate the conflict between ops "
                               "%d and %d (shared vars %r)"
                               % (i, j, shared)))

    # -- the CUDA graph ------------------------------------------------------
    def _capture(self, feeds):
        """Static feed buffers, then one capture of the stitched function
        over the carried registers' tensors (a capture launches nothing:
        the launch counters take it back out, each replay adds it)."""
        import torch
        from .ops.kernels import _launches

        dev = self.device
        feed_leaves, self._feed_structs = [], []
        for fv in feeds:
            leaves, struct = _tree_flatten(fv)
            feed_leaves.append(leaves)
            self._feed_structs.append(struct)
        self._static_feeds = []
        for leaves in feed_leaves:
            st = []
            for x in leaves:
                if isinstance(x, torch.Tensor):
                    buf = (torch.empty_like(x, device=dev) if x.is_cuda
                           else torch.empty_like(x, device="cpu")
                           .pin_memory())
                elif hasattr(x, "shape") and hasattr(x, "dtype"):
                    buf = torch.from_numpy(x.copy()).pin_memory()
                else:
                    buf = x  # a constant of the program (drift bails)
                st.append(buf)
            self._static_feeds.append(st)
        self._fill_feeds(feeds, first=True)
        static_feeds = tuple(_tree_unflatten(st, s) for st, s in
                             zip(self._static_feeds, self._feed_structs))
        carry_leaves = {k: _tree_flatten(v) for k, v in self._carry.items()}
        for k, (leaves, _s) in carry_leaves.items():
            for x in leaves:
                if not isinstance(x, torch.Tensor) or x.device != dev:
                    raise _FuseBail(
                        "carried register %d holds %s, not a tensor on %s"
                        % (k, type(x).__name__, dev))
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        from .context import prepare_capture_thread
        prepare_capture_thread(dev, stream)
        out = {}

        def record():
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                mats, new_carry = self._fused(dict(self._carry),
                                              static_feeds)
                for k, (leaves, struct) in carry_leaves.items():
                    new_leaves, new_struct = _tree_flatten(new_carry[k])
                    if new_struct != struct:
                        raise _FuseBail(
                            "register %d changed its structure" % k)
                    for own, t in zip(leaves, new_leaves):
                        if not (t is own or (
                                t.data_ptr() == own.data_ptr()
                                and t.shape == own.shape
                                and t.stride() == own.stride()
                                and t.dtype == own.dtype)):
                            own.copy_(t)
                out["mats"] = mats

        try:
            self._delta = _launches.capture(record)
        except Exception as e:  # a capture runs nothing: replay instead
            raise _FuseBail("the fused program could not be captured as a "
                            "CUDA graph: %s" % e)
        self._graph = graph
        self._static_mats = out["mats"]
        self._done = None
        _fuse_stats["captures"] += 1
        from .analysis import compile_witness as _witness
        _witness.record_capture("fused", key=self.signature[:16])

    def _fill_feeds(self, feeds, first=False):
        """Copy this iteration's feeds into the static buffers: device
        leaves on the stream (ordered before the replay), host leaves into
        the pinned buffers once the previous replay, whose in-graph copy
        reads them, has finished (an event wait, not a device sync)."""
        import torch

        if not first and self._done is not None:
            self._done.synchronize()
        for fv, st in zip(feeds, self._static_feeds):
            for x, buf in zip(_tree_flatten(fv)[0], st):
                if isinstance(buf, torch.Tensor):
                    if isinstance(x, torch.Tensor):
                        buf.copy_(x, non_blocking=x.is_cuda)
                    else:
                        buf.copy_(torch.from_numpy(x))

    def run_iteration(self, fuses):
        """Run one iteration (engine worker, inside the fused push). Raises
        :class:`_FuseBail` before any side effect when the iteration can
        still be replayed; writeback errors propagate (results may already
        be partly published, so a replay could apply them twice)."""
        import torch

        feeds = self._pending_feeds
        if feeds is not None:
            self._pending_feeds = None
        else:
            feeds = self._eval_feeds(fuses)
        if self.device is None:
            try:
                mats, new_carry = self._fused(self._carry, feeds)
            except Exception as e:
                raise _FuseBail("fused program failed: %s" % e)
            self._carry = new_carry
            regs = dict(new_carry)
            regs.update(mats)
        else:
            from .ops.kernels import _launches

            if self._graph is None:
                self._capture(feeds)
            else:
                self._fill_feeds(feeds)
            self._graph.replay()
            _launches.replayed(self._delta)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._done = done
            self.replays += 1
            regs = dict(self._carry)
            regs.update({k: _tree_unflatten(
                [t.clone() for t in _tree_flatten(v)[0]],
                _tree_flatten(v)[1]) for k, v in self._static_mats.items()})
        self.runs += 1
        for i in self._wb_ops:
            wb = fuses[i].writeback
            if wb is not None:
                wb({v: regs[self._var_idx[v]] for v in self._out_vars[i]
                    if self._var_idx[v] in regs})


class CapturedSequence:
    """Record a steady-state push sequence once, replay it with near-zero
    host overhead.

    The owning thread brackets each iteration::

        cs = engine.CapturedSequence(name="fit_step")
        for batch in loader:
            cs.begin_step()
            cs.push(load_fn, mutable_vars=[data_var], name="load")
            cs.push(step_fn, const_vars=[data_var],
                    mutable_vars=[step_var], name="step")
            cs.end_step()

    For the first ``warmup`` iterations every push forwards eagerly through
    the module-level :func:`push` / :func:`push_async` while the ``(is_async,
    name, priority, const_vars, mutable_vars)`` signature stream is
    recorded. If every warm-up iteration produced the same stream, the
    sequence compiles: ``_dedup`` runs once per op, RAW / WAR / WAW edges
    between the recorded ops become a static dependency list, and the
    union of the vars becomes the replay's var set; an unstable stream
    bails to eager until :meth:`invalidate`.

    A compiled iteration is submitted by ``end_step()`` as ONE module-level
    :func:`push_async` over the union (so in-flight accounting counts it
    once, a :func:`fence` over any of its vars orders after the whole
    replay, file vars keep their order). Inside, the recorded ops run in
    recorded order on one worker, waiting only on the precomputed edges to
    async predecessors.

    A replayed iteration that deviates (another op at slot i, fewer or
    more ops) flushes the matched prefix eagerly in order, runs the rest
    eagerly and returns to capturing: a mismatch never loses or reorders
    an op.

    One thread drives ``begin_step`` / ``push`` / ``end_step``;
    :meth:`invalidate` may be called from any thread and takes effect at
    the next ``begin_step``.
    """

    def __init__(self, name: str = "seq", warmup: Optional[int] = None,
                 fuse: Optional[bool] = None):
        self._name = name
        self._warmup = max(2, warmup) if warmup is not None \
            else capture_warmup()
        self._lock = threading.Lock()
        # "capture" (recording + eager), "ready" (replaying), "flush"
        # (mid-step after a mismatch), "eager" (bailed until invalidate())
        self._state = "capture"
        self._iters: List[list] = []
        self._cur: Optional[list] = None
        self._ops: Optional[List[tuple]] = None  # [(sig, deps), ...]
        self._union: Tuple[tuple, tuple] = ((), ())
        self._slots: List[Callable] = []
        self._invalid_reason: Optional[str] = None
        self.replays = 0
        self.bails = 0
        # trace-and-fuse (None = read MXNET_ENGINE_FUSE at use time):
        # _fuse_state None (unstaged) / "staged" / "ineligible" / "dead"
        self._fuse_opt = fuse
        self._fuse_state: Optional[str] = None
        self._fused: Optional[FusedSequence] = None
        self._fuse_slots: List[Optional[FuseOp]] = []
        self.fused_runs = 0
        self.fuse_bails = 0

    @property
    def name(self) -> str:
        return self._name

    @property
    def warmup(self) -> int:
        return self._warmup

    @property
    def state(self) -> str:
        return self._state

    @property
    def ops(self) -> Optional[List[tuple]]:
        """The compiled ``[(signature, deps), ...]`` (None until ready)."""
        return self._ops

    @property
    def fused(self) -> Optional[FusedSequence]:
        """The staged program, while the sequence runs fused."""
        return self._fused

    def stats(self) -> Dict[str, object]:
        return {"name": self._name, "state": self._state,
                "warmup": self._warmup, "replays": self.replays,
                "bails": self.bails, "fused_runs": self.fused_runs,
                "fuse_bails": self.fuse_bails,
                "fuse_state": self._fuse_state}

    def invalidate(self, reason: str):
        """Discard the recording at the next ``begin_step`` (thread-safe;
        an already-submitted replay is unaffected)."""
        with self._lock:
            if self._invalid_reason is None:
                self._invalid_reason = reason

    # -- step bracketing ------------------------------------------------
    def begin_step(self):
        reason = None
        with self._lock:
            if self._invalid_reason is not None:
                reason = self._invalid_reason
                self._invalid_reason = None
                self._reset_locked()
            elif self._state == "flush":  # the caller skipped end_step
                self._reset_locked()
            if self._state == "ready":
                self._slots = []
                self._fuse_slots = []
            elif self._state == "capture":
                self._cur = []
        if reason is not None:
            _log.info("engine capture '%s': invalidated (%s), recapturing",
                      self._name, reason)

    def end_step(self):
        st = self._state
        if st == "ready":
            with self._lock:
                slots, self._slots = self._slots, []
                fuses, self._fuse_slots = self._fuse_slots, []
            if len(slots) != len(self._ops):
                self._flush_eager(
                    slots, "iteration ended after %d of %d recorded ops"
                    % (len(slots), len(self._ops)))
                with self._lock:
                    self._reset_locked()
                return
            if self._fuse_wanted():
                with self._lock:
                    fstate = self._fuse_state
                if fstate is None:
                    self._stage_fuse(fuses)
                    with self._lock:
                        fstate = self._fuse_state
                if fstate == "staged":
                    if all(f is not None for f in fuses):
                        # counted first: a reader woken by the op's own
                        # results sees the count
                        self.fused_runs += 1
                        self._submit_fused(slots, fuses)
                        return
                    self._fuse_dead("a slot was pushed without fuse "
                                    "metadata", "run")
            self.replays += 1
            self._submit_replay(slots)
        elif st == "capture":
            cur, self._cur = self._cur, None
            if cur is not None:
                self._iters.append(cur)
                if len(self._iters) >= self._warmup:
                    self._compile()
        elif st == "flush":
            with self._lock:
                self._reset_locked()

    # -- pushes ---------------------------------------------------------
    def push(self, fn: Callable[[], None], const_vars: Sequence[int] = (),
             mutable_vars: Sequence[int] = (), priority: int = 0,
             name: str = "op", fuse: Optional[FuseOp] = None):
        """Sync push through the capture state machine; ``fuse`` carries
        the op's traceable metadata (None keeps the sequence on replay)."""
        self._push(False, fn, const_vars, mutable_vars, priority, name,
                   fuse)

    def push_async(self, fn: Callable[[Callable[[], None]], None],
                   const_vars: Sequence[int] = (),
                   mutable_vars: Sequence[int] = (), priority: int = 0,
                   name: str = "op", fuse: Optional[FuseOp] = None):
        """Async push through the capture state machine; a fused iteration
        publishes the op's effects through ``FuseOp.writeback``."""
        self._push(True, fn, const_vars, mutable_vars, priority, name,
                   fuse)

    def _push(self, is_async, fn, const_vars, mutable_vars, priority, name,
              fuse=None):
        sig = (is_async, name, int(priority),
               tuple(const_vars), tuple(mutable_vars))
        st = self._state
        if st == "ready":
            i = len(self._slots)
            if i < len(self._ops) and self._ops[i][0] == sig:
                self._slots.append(fn)
                self._fuse_slots.append(fuse)
                return
            with self._lock:
                slots, self._slots = self._slots, []
                self._fuse_slots = []
                self._state = "flush"
            self._flush_eager(
                slots, "op %d is %r, recorded %r" % (
                    i, name,
                    self._ops[i][0][1] if i < len(self._ops) else "<end>"))
        elif st == "capture":
            if self._cur is not None:
                self._cur.append(sig)
        # capture warm-up, flush and bailed-eager all forward eagerly
        if is_async:
            push_async(fn, const_vars, mutable_vars, priority, name)
        else:
            push(fn, const_vars, mutable_vars, priority, name)

    # -- internals ------------------------------------------------------
    def _reset_locked(self):
        self._state = "capture"
        self._iters = []
        self._cur = None
        self._ops = None
        self._slots = []
        self._fuse_slots = []
        self._fuse_state = None
        self._fused = None

    def _flush_eager(self, slots, why):
        """Replay deviated: run the matched prefix eagerly, in recorded
        order, so nothing is lost or reordered."""
        self.bails += 1
        _log.info("engine capture '%s': replay mismatch (%s); flushing %d "
                  "op(s) eagerly and recapturing", self._name, why,
                  len(slots))
        for j, fn in enumerate(slots):
            s_async, s_name, s_pri, s_const, s_mut = self._ops[j][0]
            if s_async:
                push_async(fn, s_const, s_mut, s_pri, s_name)
            else:
                push(fn, s_const, s_mut, s_pri, s_name)

    def _compile(self):
        """Every warm-up iteration observed: verify stability and resolve
        the dependency edges once, or bail to eager."""
        first = self._iters[0]
        if not first:
            self._iters = []  # empty steps: nothing to replay, keep looking
            return
        for k, it in enumerate(self._iters[1:], 1):
            if it != first:
                with self._lock:
                    self._state = "eager"
                    self._iters = []
                self.bails += 1
                _log.info(
                    "engine capture '%s': unstable across warmup (iteration "
                    "%d has %d op(s), first had %d; or var topology "
                    "changed) — staying eager until invalidated",
                    self._name, k, len(it), len(first))
                return
        ops = []
        last_writer: Dict[int, int] = {}
        readers_since: Dict[int, list] = {}
        union_mut: Dict[int, None] = {}
        union_const: Dict[int, None] = {}
        for i, sig in enumerate(first):
            const, mut = _dedup(sig[3], sig[4])  # per-op _dedup, once
            deps = set()
            for v in const:
                if v in last_writer:
                    deps.add(last_writer[v])            # RAW
            for v in mut:
                if v in last_writer:
                    deps.add(last_writer[v])            # WAW
                deps.update(readers_since.get(v, ()))   # WAR
            for v in const:
                readers_since.setdefault(v, []).append(i)
                union_const.setdefault(v)
            for v in mut:
                last_writer[v] = i
                readers_since[v] = []
                union_mut.setdefault(v)
            ops.append((sig, tuple(sorted(deps))))
        u_mut = tuple(union_mut)
        u_const = tuple(v for v in union_const if v not in union_mut)
        with self._lock:
            self._ops = ops
            self._union = (u_const, u_mut)
            self._iters = []
            self._state = "ready"
        _log.info("engine capture '%s': captured %d op(s) over %d vars, "
                  "replaying", self._name, len(ops),
                  len(u_const) + len(u_mut))

    def _submit_replay(self, slots):
        """One iteration as a single module-level push_async over the
        union var set; inside, ops run in recorded order."""
        ops = self._ops
        seq_name = self._name

        def replay(on_complete, _slots=slots, _ops=ops):
            tok = _telemetry.begin("engine.replay", domain="engine",
                                   ops=len(_ops), sequence=seq_name) \
                if _telemetry.enabled("engine") else None
            self._replay_children(_slots, _ops, seq_name)
            if tok is not None:
                _telemetry.end(tok)
            on_complete()

        push_async(replay, self._union[0], self._union[1],
                   name="replay:%s" % seq_name)

    @staticmethod
    def _replay_children(slots, ops, seq_name):
        """Run one iteration's recorded ops in order on the current worker,
        waiting only on the precomputed edges to async predecessors."""
        on_engine = _telemetry.enabled("engine")
        san = _san  # read once per replay: tests may toggle mid-run
        conf = san.replay_conflicts(ops) if san is not None else None
        events: List[Optional[threading.Event]] = [None] * len(ops)
        for i, (sig, deps) in enumerate(ops):
            is_async, opname = sig[0], sig[1]
            for d in deps:
                ev = events[d]
                if ev is not None:  # sync deps completed in program order
                    ev.wait()
            if conf is not None:
                san.on_replay_child(seq_name, i, ops, conf, events)
            fn = slots[i]
            try:
                if is_async:
                    done_ev = threading.Event()
                    events[i] = done_ev
                    if on_engine:
                        optok = _telemetry.begin(opname, domain="engine",
                                                 replay=True)

                        def done(_ev=done_ev, _t=optok):
                            _telemetry.end(_t)
                            _ev.set()
                    else:
                        done = done_ev.set
                    fn(done)
                else:
                    if on_engine:
                        with _telemetry.span(opname, domain="engine",
                                             replay=True):
                            fn()
                    else:
                        fn()
            except Exception as e:  # mirror _dispatch: never escape the op
                traceback.print_exc()
                _notify_op_error(opname, e)
                if events[i] is not None:
                    events[i].set()
        # the submission completes only when every child has
        for ev in events:
            if ev is not None:
                ev.wait()

    # -- trace-and-fuse -------------------------------------------------
    def _fuse_wanted(self) -> bool:
        return self._fuse_opt if self._fuse_opt is not None \
            else fuse_enabled()

    def _fuse_dead(self, why: str, kind: str):
        with self._lock:
            self._fused = None
            self._fuse_state = "dead"
        self.fuse_bails += 1
        _count_fuse_bail(kind)
        _log.info("engine fuse '%s': %s; falling back to replay until the "
                  "sequence recaptures", self._name, why)

    def _stage_fuse(self, fuses):
        """First ready iteration with fusing asked for: stage the recorded
        sequence, or record why it cannot be."""
        try:
            missing = [i for i, f in enumerate(fuses) if f is None]
            if missing:
                raise _FuseIneligible(
                    "op(s) %s (%s) carry no traceable metadata"
                    % (missing,
                       ", ".join(self._ops[i][0][1] for i in missing)))
            prog = FusedSequence(self._name, self._ops, fuses, self._union)
        except _FuseIneligible as e:
            with self._lock:
                self._fuse_state = "ineligible"
            self.fuse_bails += 1
            _count_fuse_bail("ineligible")
            _log.info("engine fuse '%s': ineligible (%s); staying on "
                      "replay", self._name, e)
        except Exception:
            with self._lock:
                self._fuse_state = "dead"
            self.fuse_bails += 1
            _count_fuse_bail("stage")
            _log.warning("engine fuse '%s': staging failed; staying on "
                         "replay", self._name, exc_info=True)
        else:
            with self._lock:
                self._fused = prog
                self._fuse_state = "staged"

    def _submit_fused(self, slots, fuses):
        """One iteration as a single module-level push_async running the
        staged program, over the same union as replay. A pre-execution
        bail replays the iteration's recorded closures inline."""
        prog = self._fused
        ops = self._ops
        seq_name = self._name
        prog.san_check(ops)

        def fused_run(on_complete, _slots=slots, _fuses=fuses, _prog=prog,
                      _ops=ops):
            tok = _telemetry.begin("engine.fused_run", domain="engine",
                                   ops=len(_ops), sequence=seq_name,
                                   signature=_prog.signature[:12]) \
                if _telemetry.enabled("engine") else None
            try:
                _prog.run_iteration(_fuses)
                _fuse_stats["runs"] += 1
                _fused_runs_counter.inc()
            except _FuseBail as e:
                # nothing was published yet: the iteration replays whole
                self._fuse_dead("bailed (%s)" % e, "run")
                self._replay_children(_slots, _ops, seq_name)
            except Exception as e:
                # a writeback failed mid-publish: replaying could apply
                # effects twice, so surface it like a failed engine op
                self._fuse_dead("writeback failed (%s)" % e, "error")
                traceback.print_exc()
                _notify_op_error("fused:%s" % seq_name, e)
            finally:
                if tok is not None:
                    _telemetry.end(tok)
                on_complete()

        push_async(fused_run, self._union[0], self._union[1],
                   name="fused:%s" % seq_name)


# --- happens-before sanitizer (MXNET_ENGINE_SANITIZER) -----------------------
# Every module-level push is checked against shadow epochs per engine var.
# Host state registered with guard_state(obj, var) is found by a bounded
# reachability scan over the pushed fn (closure cells, defaults,
# functools.partial, bound-method instances, one helper level deep);
# reaching it without declaring its var, while a prior access is not yet
# settled by a fence / wait on that var, is a race. Checks run at push time
# only: op fns run exactly as without the sanitizer. Replays also check
# that the pre-resolved edge set dominates the conflict set. Disabled,
# `_san` is None and every hook is one global load and a branch.
_san = None
_san_lock = threading.Lock()  # guards the shadow tables only


def _san_site() -> str:
    """First stack frame outside this file — the user-visible push site."""
    for fr in reversed(traceback.extract_stack(limit=12)[:-2]):
        if not fr.filename.endswith("engine.py"):
            return "%s:%d" % (os.path.basename(fr.filename), fr.lineno)
    return "<engine>"


class _ShadowVar:
    __slots__ = ("epoch", "decl_epoch", "synced", "last", "deleted")

    def __init__(self):
        self.epoch = 0       # every tracked access, declared or undeclared
        self.decl_epoch = 0  # high-water mark of declared accesses only
        self.synced = 0      # decl_epoch as of the last fence/wait on the var
        self.last = None     # (op, site, mode, declared-var frozenset)
        self.deleted = None  # site of delete_variable once deleted

    def settled(self) -> bool:
        return self.epoch <= self.synced


class _Sanitizer:
    """Shadow-state tracker behind the module-level engine API."""

    MAX_REPORTS = 1000

    def __init__(self):
        self._vars: Dict[int, _ShadowVar] = {}
        # id(obj) -> (obj, var, desc); strong refs so ids are never reused
        self._guards: Dict[int, Tuple[object, int, str]] = {}
        self.reports: List[dict] = []

    def guard(self, obj, var, desc):
        with _san_lock:
            self._guards[id(obj)] = (obj, int(var), desc)

    def unguard(self, obj):
        with _san_lock:
            self._guards.pop(id(obj), None)

    def _reachable_guards(self, fn):
        """Guarded objects reachable from a pushed callable."""
        found, seen = [], set()
        stack = [(fn, 2)]
        budget = 256
        while stack and budget:
            obj, depth = stack.pop()
            oid = id(obj)
            if oid in seen:
                continue
            seen.add(oid)
            budget -= 1
            hit = self._guards.get(oid)
            if hit is not None and hit[0] is obj:
                found.append((hit[1], hit[2]))
                continue
            if depth <= 0:
                continue
            if isinstance(obj, functools.partial):
                stack.append((obj.func, depth))
                stack.extend((a, depth) for a in obj.args)
                stack.extend((v, depth) for v in obj.keywords.values())
            elif isinstance(obj, (list, tuple, set, frozenset)):
                stack.extend((e, depth) for e in list(obj)[:32])
            elif isinstance(obj, dict):
                stack.extend((v, depth) for v in list(obj.values())[:32])
            elif isinstance(obj, (types.ModuleType, type)):
                pass  # never walk module/class namespaces
            else:
                inst = getattr(obj, "__self__", None)
                if inst is not None and not isinstance(
                        inst, (types.ModuleType, type)):
                    stack.append((inst, depth - 1))
                f = getattr(obj, "__func__", obj)
                cells = getattr(f, "__closure__", None)
                if cells:
                    for c in cells:
                        try:
                            stack.append((c.cell_contents, depth - 1))
                        except ValueError:  # empty cell
                            pass
                dfl = getattr(f, "__defaults__", None)
                if dfl:
                    stack.extend((v, depth - 1) for v in dfl)
                code = getattr(f, "__code__", None)
                gl = getattr(f, "__globals__", None)
                if code is not None and gl is not None:
                    for nm in code.co_names[:32]:
                        if nm in gl:
                            stack.append((gl[nm], depth - 1))
                if not callable(obj):
                    d = getattr(obj, "__dict__", None)
                    if isinstance(d, dict):
                        stack.extend(
                            (v, depth - 1) for v in list(d.values())[:64])
        return found

    # -- hooks ---------------------------------------------------------------
    def on_new(self, var):
        with _san_lock:
            self._vars.pop(int(var), None)

    def on_delete(self, var):
        site = _san_site()
        with _san_lock:
            self._vars.setdefault(int(var), _ShadowVar()).deleted = site

    def on_sync(self, vars):
        """A wait completed: declared accesses on ``vars`` (all if None)
        happened-before this point."""
        with _san_lock:
            if vars is None:
                cells = list(self._vars.values())
            else:
                cells = [self._vars[v] for v in (int(x) for x in vars)
                         if v in self._vars]
            for cell in cells:
                cell.synced = cell.decl_epoch

    def on_fence(self, vars, name):
        site = _san_site()
        out = []
        with _san_lock:
            for v in (int(x) for x in vars):
                cell = self._vars.get(v)
                if cell is not None and cell.deleted is not None:
                    out.append(self._mk(
                        "var-use-after-delete", v, name, site,
                        "delete_variable", cell.deleted,
                        detail="fence names var %d after deletion" % v))
        for rep in out:
            self._emit(rep)

    def on_push(self, fn, const_vars, mutable_vars, name):
        site = _san_site()
        mut = {int(v) for v in mutable_vars}
        declared = {int(v) for v in const_vars} | mut
        touched = self._reachable_guards(fn)
        out = []
        with _san_lock:
            for v in sorted(declared):
                cell = self._vars.get(v)
                if cell is not None and cell.deleted is not None:
                    out.append(self._mk(
                        "var-use-after-delete", v, name, site,
                        "delete_variable", cell.deleted,
                        detail="op declares var %d after deletion" % v))
            for v, desc in touched:
                if v in declared:
                    continue  # ordered: the engine sees this access
                cell = self._vars.setdefault(v, _ShadowVar())
                last = cell.last
                if not cell.settled() and last is not None \
                        and not (declared & last[3]):
                    out.append(self._mk(
                        "undeclared-var-access", v, name, site,
                        last[0], last[1],
                        detail="op reaches state %r guarded by var %d "
                               "without declaring it" % (desc, v)))
                cell.epoch += 1
                cell.last = (name, site, "undeclared", frozenset(declared))
            for v in sorted(declared):
                cell = self._vars.setdefault(v, _ShadowVar())
                last = cell.last
                if not cell.settled() and last is not None \
                        and last[2] == "undeclared" \
                        and not (declared & last[3]):
                    out.append(self._mk(
                        "undeclared-var-access", v, name, site,
                        last[0], last[1],
                        detail="declared access races the earlier "
                               "undeclared access to var %d" % v))
                cell.epoch += 1
                cell.decl_epoch = cell.epoch
                cell.last = (name, site,
                             "write" if v in mut else "read",
                             frozenset(declared))
        for rep in out:
            self._emit(rep)

    # -- replay validation ---------------------------------------------------
    @staticmethod
    def replay_conflicts(ops):
        """For each recorded op, every earlier op sharing a var with at
        least one writer; the pre-resolved edge set must dominate it."""
        conf = []
        writers: Dict[int, List[int]] = {}
        readers: Dict[int, List[int]] = {}
        for i, (sig, _deps) in enumerate(ops):
            const, mutv = _dedup(sig[3], sig[4])
            c = set()
            for v in const:
                c.update(writers.get(v, ()))
            for v in mutv:
                c.update(writers.get(v, ()))
                c.update(readers.get(v, ()))
            conf.append(tuple(sorted(c)))
            for v in const:
                readers.setdefault(v, []).append(i)
            for v in mutv:
                writers.setdefault(v, []).append(i)
                readers[v] = []
        return conf

    def on_replay_child(self, seq, i, ops, conf, events):
        for j in conf[i]:
            ev = events[j]
            if ev is None or ev.is_set():
                continue  # sync child (done in program order) or completed
            sig_i, sig_j = ops[i][0], ops[j][0]
            shared = sorted(
                ({int(v) for v in sig_i[3]} | {int(v) for v in sig_i[4]})
                & ({int(v) for v in sig_j[3]} | {int(v) for v in sig_j[4]}))
            self._emit(self._mk(
                "replay-edge-violation", shared[0] if shared else -1,
                sig_i[1], "%s[%d]" % (seq, i), sig_j[1], "%s[%d]" % (seq, j),
                detail="replay child %d starts before conflicting async "
                       "child %d completed (shared vars %r): pre-resolved "
                       "edges do not dominate the access set" % (i, j,
                                                                 shared)))

    # -- reporting -----------------------------------------------------------
    @staticmethod
    def _mk(rule, var, op, site, other_op, other_site, detail=""):
        return {"rule": rule, "var": int(var), "op": op, "site": site,
                "other_op": other_op, "other_site": other_site,
                "detail": detail,
                "stack": "".join(traceback.format_stack(limit=8)[:-2])}

    def _emit(self, rep):
        with _san_lock:
            if len(self.reports) < self.MAX_REPORTS:
                self.reports.append(rep)
        _san_counter.inc()
        _log.error(
            "engine sanitizer [%s] var %d: op '%s' at %s vs op '%s' at %s"
            " — %s", rep["rule"], rep["var"], rep["op"], rep["site"],
            rep["other_op"], rep["other_site"], rep["detail"])


_san_counter = _telemetry.registry.counter(
    "engine_sanitizer_reports_total",
    help="Races reported by the engine happens-before sanitizer")


def sanitizer_enabled() -> bool:
    return _san is not None


def sanitizer_enable(on: bool = True):
    """Turn the happens-before sanitizer on (fresh shadow state) or off;
    the import-time switch is MXNET_ENGINE_SANITIZER=1."""
    global _san
    _san = _Sanitizer() if on else None


def sanitizer_reports() -> List[dict]:
    """Race reports since the sanitizer was (re-)enabled."""
    if _san is None:
        return []
    with _san_lock:
        return list(_san.reports)


def sanitizer_clear():
    """Drop accumulated reports; shadow epochs and guards are kept."""
    if _san is not None:
        with _san_lock:
            del _san.reports[:]


def guard_state(obj, var, name: Optional[str] = None):
    """Register ``obj`` (host state) as ordered by ``var``: a pushed fn that
    reaches ``obj`` without declaring ``var`` races every unsettled
    access. No-op while the sanitizer is off."""
    if _san is not None:
        _san.guard(obj, var, name or type(obj).__name__)
    return obj


def unguard_state(obj):
    if _san is not None:
        _san.unguard(obj)


if _env_on("MXNET_ENGINE_SANITIZER"):
    _san = _Sanitizer()


# --- per-var in-flight accounting --------------------------------------------
# A var registered with track_inflight() has every module-level push /
# push_async naming it counted at push time and released when the op
# completes (sync: fn returned; async: on_complete ran). Untracked vars cost
# one dict probe a push.
_inflight: Dict[int, int] = {}
_inflight_lock = threading.Lock()


def track_inflight(var: int):
    """Register ``var`` for in-flight accounting (idempotent)."""
    with _inflight_lock:
        _inflight.setdefault(int(var), 0)


def untrack_inflight(var: int):
    """Stop accounting for ``var`` and drop its counter."""
    with _inflight_lock:
        _inflight.pop(int(var), None)


def var_inflight(var: int) -> int:
    """Ops queued or running that name ``var`` (0 if untracked)."""
    with _inflight_lock:
        return _inflight.get(int(var), 0)


def _inflight_begin(vars_) -> tuple:
    """Count a push against every tracked var in ``vars_``; the vars
    counted."""
    if not _inflight:  # tracking starts before the pushes it counts
        return ()
    counted = []
    with _inflight_lock:
        for v in vars_:
            if v in _inflight:
                _inflight[v] += 1
                counted.append(v)
    return tuple(counted)


def _inflight_end(counted: tuple):
    with _inflight_lock:
        for v in counted:
            if v in _inflight:
                _inflight[v] -= 1


def _wrap_inflight_sync(fn, counted):
    def run():
        try:
            fn()
        finally:
            _inflight_end(counted)
    return run


def _wrap_inflight_async(fn, counted):
    def run(on_complete):
        released = []  # once: the engine's error path may complete again

        def done():
            if not released:
                released.append(1)
                _inflight_end(counted)
            on_complete()

        try:
            fn(done)
        except BaseException:
            if not released:
                released.append(1)
                _inflight_end(counted)
            raise
    return run


# --- file-write routing ------------------------------------------------------
# Checkpoint writes ride the engine with one write-var a path: writers push
# with the path's var mutable, readers wait on it, so an in-flight async
# checkpoint is never half-read.
_file_vars: Dict[str, int] = {}
_file_pending: Dict[str, int] = {}  # writes queued or running per path
_file_waiting: Dict[str, int] = {}  # waiters pinning the var per path
_file_errs: Dict[str, BaseException] = {}
_file_lock = threading.Lock()


def file_var(path: str) -> int:
    """The engine write-var owning ``path`` (created on first use)."""
    path = os.path.abspath(path)
    with _file_lock:
        v = _file_vars.get(path)
        if v is None:
            v = get().new_variable()
            _file_vars[path] = v
        return v


def push_file_write(path: str, fn: Callable[[], None], wait: bool = True,
                    name: Optional[str] = None,
                    after_paths: Sequence[str] = ()):
    """Run ``fn`` (which writes ``path``) as an engine op holding the
    path's write-var; ``wait=False`` returns at once. A failed write
    raises at the next :func:`wait_for_file` of its path, or at the next
    file write or :func:`wait_for_all` of any path. ``after_paths`` orders
    this write after every write already pushed on those paths."""
    apath = os.path.abspath(path)
    _raise_pending_file_error()
    eng = get()
    deps = []
    with _file_lock:
        var = _file_vars.get(apath)
        if var is None:
            var = eng.new_variable()
            _file_vars[apath] = var
        # counted under the lock that resolved the var, so wait_for_file
        # never retires a var with a write on its way
        _file_pending[apath] = _file_pending.get(apath, 0) + 1
        dep_paths = []
        for p in after_paths:
            ap = os.path.abspath(p)
            if ap == apath:
                continue
            dv = _file_vars.get(ap)
            if dv is None:
                continue  # nothing ever written there: no edge needed
            deps.append(dv)
            dep_paths.append(ap)
            _file_pending[ap] = _file_pending.get(ap, 0) + 1

    def run():
        try:
            fn()
        except BaseException as e:  # raised at the next sync point
            with _file_lock:
                _file_errs[apath] = e
        finally:
            with _file_lock:
                _file_pending[apath] -= 1
                for ap in dep_paths:
                    _file_pending[ap] -= 1

    eng.push(run, const_vars=deps, mutable_vars=[var],
             name=name or ("file_write:%s" % os.path.basename(apath)))
    if wait:
        wait_for_file(apath)


def _raise_pending_file_error():
    with _file_lock:
        if not _file_errs:
            return
        path, err = next(iter(_file_errs.items()))
        del _file_errs[path]
    raise err


def _retire_file_var(apath: str, var: int):
    """Drop the path's var only if no write is queued or running, no other
    waiter holds it and the mapping is unchanged; the engine's delete is
    itself ordered after the var's ops."""
    with _file_lock:
        if (_file_pending.get(apath, 0) != 0
                or _file_waiting.get(apath, 0) != 0
                or _file_vars.get(apath) is not var):
            return
        del _file_vars[apath]
        _file_pending.pop(apath, None)
    get().delete_variable(var)


def wait_for_file(path: str):
    """Block until every write pushed for ``path`` has run; raise the
    failure of one, if any. A drained path's var is retired."""
    apath = os.path.abspath(path)
    with _file_lock:
        var = _file_vars.get(apath)
        if var is not None:
            _file_waiting[apath] = _file_waiting.get(apath, 0) + 1
    if var is not None:
        try:
            get().wait_for_var(var)
        finally:
            with _file_lock:
                _file_waiting[apath] -= 1
                if _file_waiting[apath] == 0:
                    del _file_waiting[apath]
        _retire_file_var(apath, var)
    with _file_lock:
        err = _file_errs.pop(apath, None)
    if err is not None:
        raise err


def wait_for_all_files():
    """Drain every pending file write, then raise the first failure."""
    with _file_lock:
        pending = list(_file_vars)
    first_err = None
    for apath in pending:
        try:
            wait_for_file(apath)
        except BaseException as e:
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    _raise_pending_file_error()


# queue depth for the metrics registry: the callback reads the module
# global at scrape time and never creates an engine itself
_telemetry.registry.gauge(
    "engine_pending_ops",
    fn=lambda: _engine.pending() if _engine is not None else 0,
    help="ops queued or running on the host dependency engine")
