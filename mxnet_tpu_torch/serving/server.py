"""In-process dynamic-batching inference server.

Counterpart of ``mxnet_tpu/serving/server.py``. The pipeline (each stage
a host-engine op or a thread of its own, so they overlap):

    clients --submit--> BatchFormer (bounded queue, deadlines)
                            |  former loop (thread): coalesce + pick replica
                            v
             engine.push_async(dispatch, mutable_vars=[replica.var])
                            |  engine worker: pad -> the bucket's forward
                            v
                 per-request result futures + ServingMetrics

Each replica is a ``BucketCache`` over a ``Predictor`` on its device (a
CUDA graph a bucket on a card), a ``StagingPool`` (pinned host buffers on
a card) and an engine variable: dispatches to one replica serialize on
its variable, dispatches to different replicas run concurrently on the
engine's workers, while the former keeps coalescing the next micro-batch.
The ``rr`` / ``least_loaded`` routers,
adaptive ladder retunes (``BucketTuner``), ``warm`` / ``ready`` and
``stop(drain)`` are the reference's. With ``decode=GenerateConfig(...)``
the server also fronts a ``DecodeScheduler`` (``submit_stream`` /
``generate``) over the same weights, one KV cache a replica.

Configuration comes from ``ServingConfig`` with ``MXNET_SERVING_*`` env
defaults. ``ServingConfig.capture`` (``MXNET_ENGINE_CAPTURE``) routes each
dispatch through a ``CapturedSequence`` kept per (replica, nominal bucket)
and invalidated by a ladder swap; ``fuse`` (``MXNET_ENGINE_FUSE``) also
stitches the dispatch into one fused program over the bucket Predictor's
forward (on a card one CUDA graph of the staged inputs' host-to-device
copy and the forward), which bails to replay when ``acquire()`` resolves
another bucket.

With the persistent program cache on (``MXNET_PROGCACHE`` /
``MXNET_PROGCACHE_DIR``) a server adopts the ladder a previous process
tuned and saved (``BucketCache.restore_ladder``) and binds its whole
ladder at start, each bucket a disk load of its exported forward.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import engine
from .. import predict as predict_mod
from .. import progcache as _progcache
from .. import telemetry
from ..context import resolve_device
from ..telemetry import context as trace_context
from ..telemetry import flight as _flight
from .batcher import BatchFormer, Request, ServingError
from .bucket_cache import BucketCache
from .generate import (DecodeModel, DecodeScheduler, DecodeSpec,
                       GenerateConfig, TokenStream)
from .metrics import ServingBatchEndParam, ServingMetrics
from .staging import StagingPool
from .tuner import BucketTuner

_log = logging.getLogger("mxnet_tpu_torch")


def _env_buckets() -> tuple:
    raw = os.environ.get("MXNET_SERVING_BUCKETS", "1,4,8")
    return tuple(int(x) for x in raw.replace(" ", "").split(",") if x)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "0").lower() not in ("0", "", "false", "off")


@dataclass
class ServingConfig:
    """Batch-former / queue / replica / hot-path knobs (``MXNET_SERVING_*``
    env defaults read at construction, as the reference's)."""
    buckets: Sequence[int] = field(default_factory=_env_buckets)
    max_delay_ms: float = field(default_factory=lambda: float(
        os.environ.get("MXNET_SERVING_MAX_DELAY_MS", "2.0")))
    queue_depth: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_SERVING_QUEUE_DEPTH", "256")))
    timeout_ms: float = field(default_factory=lambda: float(
        os.environ.get("MXNET_SERVING_TIMEOUT_MS", "1000")))
    replicas: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_SERVING_REPLICAS", "1")))
    warm: bool = field(default_factory=lambda: bool(int(
        os.environ.get("MXNET_SERVING_WARM", "0"))))
    #: adaptive bucket ladders: a BucketTuner re-derives the ladder from
    #: the observed request-size histogram every retune_interval batches
    adaptive: bool = field(default_factory=lambda: bool(int(
        os.environ.get("MXNET_SERVING_ADAPTIVE", "0"))))
    #: max bound forwards per replica an adaptive ladder may use
    program_budget: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_SERVING_PROGRAM_BUDGET", "8")))
    #: cross-bucket coalescing: pack toward the largest ladder bucket that
    #: is >= this percent full (0 disables; 100 = only full buckets)
    coalesce_fill_pct: float = field(default_factory=lambda: float(
        os.environ.get("MXNET_SERVING_COALESCE_FILL_PCT", "0")))
    #: replica routing: "rr" round-robin, or "least_loaded" = fewest
    #: outstanding engine ops on the replica's var (engine.var_inflight)
    router: str = field(default_factory=lambda: os.environ.get(
        "MXNET_SERVING_ROUTER", "rr"))
    #: assemble batches in reusable per-(replica, bucket) staging buffers
    #: instead of per-dispatch np.zeros + concatenate
    zero_copy: bool = field(default_factory=lambda: bool(int(
        os.environ.get("MXNET_SERVING_ZERO_COPY", "1"))))
    #: batches between retune passes (adaptive only)
    retune_interval: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_SERVING_RETUNE_INTERVAL", "64")))
    #: min observed requests before the tuner will propose a ladder
    retune_min_samples: int = field(default_factory=lambda: int(
        os.environ.get("MXNET_SERVING_RETUNE_MIN_SAMPLES", "64")))
    #: engine capture/replay of the dispatch (MXNET_ENGINE_CAPTURE): one
    #: CapturedSequence per (replica, nominal bucket)
    capture: bool = field(
        default_factory=lambda: _env_flag("MXNET_ENGINE_CAPTURE"))
    #: trace-and-fuse of the captured dispatch (MXNET_ENGINE_FUSE; needs
    #: capture)
    fuse: bool = field(default_factory=lambda: _env_flag("MXNET_ENGINE_FUSE"))
    #: post-training weight quantization for the replicas: "" (off) | int8
    #: | fp8_e4m3. Each replica binds a quant.QuantizedPredictor; its
    #: bucket ladder shares ONE quantization.
    quant_weights: str = field(default_factory=lambda: os.environ.get(
        "MXNET_QUANT_WEIGHT_DTYPE", ""))


class _Replica:
    __slots__ = ("index", "device", "cache", "var", "staging", "dispatched",
                 "captures")

    def __init__(self, index: int, device, cache: BucketCache, var: int,
                 staging: StagingPool):
        self.index = index
        self.device = device
        self.cache = cache
        self.var = var
        self.staging = staging
        self.dispatched = 0
        #: one CapturedSequence per nominal bucket; written by the former
        #: thread, invalidated and cleared by retunes and stop
        self.captures: Dict[int, "engine.CapturedSequence"] = {}


def _host(o) -> np.ndarray:
    """An output on the host: a copy on the caller's stream that waits for
    it (never a device-wide synchronize, which another replica's capture
    would see)."""
    return _host_tensor(o._data)


def _host_tensor(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class InferenceServer:
    """Dynamic-batching server over bucketed Predictor executors.

    ``symbol``: Symbol, symbol-JSON string, or path. ``params``: params
    path or dict (Predictor semantics). ``example_shapes``: per-example
    input shapes WITHOUT the batch axis, e.g. ``{"data": (3, 224, 224)}``.
    ``devices``: torch devices, one replica on each of the first
    ``replicas`` entries; default every replica on the card (``cuda``).
    """

    def __init__(self, symbol, params, example_shapes: Dict[str, tuple],
                 dtype: str = "float32",
                 config: Optional[ServingConfig] = None,
                 batch_end_callback: Optional[Callable] = None,
                 devices: Optional[Sequence] = None,
                 decode: Optional[GenerateConfig] = None):
        self.config = config or ServingConfig()
        if not self.config.buckets:
            raise ServingError("no buckets configured")
        self._example_shapes = {n: tuple(s)
                                for n, s in example_shapes.items()}
        self._input_names = list(self._example_shapes)
        self._dtype = dtype
        self._batch_end_callback = batch_end_callback
        symbol_json = symbol.tojson() if hasattr(symbol, "tojson") else symbol

        n_rep = max(1, int(self.config.replicas))
        if devices is not None and len(devices) < n_rep:
            raise ServingError("need %d devices for %d replicas, got %d"
                               % (n_rep, n_rep, len(devices)))
        if self.config.router not in ("rr", "least_loaded"):
            raise ServingError(
                "MXNET_SERVING_ROUTER must be 'rr' or 'least_loaded', got %r"
                % (self.config.router,))
        if not 0.0 <= float(self.config.coalesce_fill_pct) <= 100.0:
            raise ServingError("coalesce_fill_pct must be in [0, 100]")
        ladder = tuple(sorted(set(int(b) for b in self.config.buckets)))
        smallest = ladder[0]
        self._replicas: List[_Replica] = []
        for i in range(n_rep):
            dev = resolve_device(devices[i] if devices is not None else None)
            base = predict_mod.Predictor(
                symbol_json, params,
                {n: (smallest,) + s for n, s in self._example_shapes.items()},
                dtype=dtype, device=dev)
            if self.config.quant_weights:
                base = base.quantize(self.config.quant_weights)
            cache = BucketCache(base, self.config.buckets, device=dev)
            var = engine.new_variable()
            # the least-loaded router and the router_inflight_replica<N>
            # gauges read this var's in-flight count
            engine.track_inflight(var)
            self._replicas.append(_Replica(
                i, dev, cache, var,
                StagingPool(self._example_shapes,
                            pinned=dev.type == "cuda")))
        self._rr = 0

        # the live ladder (read lock-free by the former/dispatch: tuple
        # rebind is atomic) + its version, bumped by every adaptive swap
        self._ladder = ladder
        self._ladder_version = 0
        self._tuner: Optional[BucketTuner] = None
        self._tuner_var: Optional[int] = None
        if self.config.adaptive:
            if self.config.program_budget < 1:
                raise ServingError("program_budget must be >= 1")
            self._tuner = BucketTuner(
                max_batch=ladder[-1],
                program_budget=self.config.program_budget,
                min_samples=self.config.retune_min_samples)
            # retunes serialize on an engine var of their own
            self._tuner_var = engine.new_variable()

        self.metrics = ServingMetrics(
            cache_stats_fn=self._cache_stats,
            router_inflight_fn=self._router_inflight,
            ladder_version_fn=lambda: self._ladder_version)
        # continuous-batching decode: the scheduler's model is made from
        # the SAME loaded weights as the fixed path's, on replica 0's
        # device, with one KV cache (and engine var) a replica
        self._decode: Optional[DecodeScheduler] = None
        if decode is not None:
            base = self._replicas[0].cache._base
            dm = DecodeModel.from_arg_params(
                base._arg_params,
                DecodeSpec(num_heads=decode.num_heads,
                           num_kv_heads=decode.num_kv_heads,
                           rope_base=decode.rope_base), dtype=dtype,
                device=base._device)
            self._decode = DecodeScheduler(dm, decode, replicas=n_rep)

        self._former = self._make_former()
        self._nbatch = 0
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # with the program cache on, a restarted server adopts the ladder a
        # previous process tuned and saved, then binds that whole ladder
        # now: each bucket a disk load, not a trace
        if self.config.warm or _progcache.enabled():
            budget = (self.config.program_budget
                      if self.config.adaptive else None)
            for rep in self._replicas:
                if _progcache.enabled():
                    rep.cache.restore_ladder(budget)
                rep.cache.warm()
            if _progcache.enabled():
                self._ladder = tuple(self._replicas[0].cache.buckets)

    def _make_former(self) -> BatchFormer:
        former = BatchFormer(
            max_batch=max(self.config.buckets),
            max_delay_ms=self.config.max_delay_ms,
            queue_depth=self.config.queue_depth,
            error_hook=self.metrics.record_error,
            buckets_fn=lambda: self._ladder,
            coalesce_fill=self.config.coalesce_fill_pct / 100.0)
        # the reference divides its reject-early backlog estimate by the
        # replicas, which its engine runs at once
        former.parallelism = len(self._replicas)
        self.metrics._queue_depth_fn = former.depth
        return former

    # --- cache stats aggregated over replicas -----------------------------
    def _cache_stats(self) -> Dict:
        agg = {"hits": 0, "misses": 0, "compiles": 0, "disk_hits": 0,
               "cache_hits": 0}
        for rep in self._replicas:
            s = rep.cache.stats()
            for k in agg:
                agg[k] += s[k]
        return agg

    def _router_inflight(self) -> List[int]:
        """Per-replica outstanding engine-op counts (the router's signal
        and the router_inflight_replica<N> gauges)."""
        return [engine.var_inflight(rep.var) if rep.var is not None else 0
                for rep in self._replicas]

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "InferenceServer":
        """Start (or restart) the former loop. A stopped server restarts
        cleanly: close() is permanent on a BatchFormer, so a fresh one is
        built, and the replica engine variables stop() deleted are issued
        again."""
        if self._started:
            return self
        if self._former.closed():
            self._former = self._make_former()
            for rep in self._replicas:
                if rep.var is None:
                    rep.var = engine.new_variable()
                    engine.track_inflight(rep.var)
            if self._tuner is not None and self._tuner_var is None:
                self._tuner_var = engine.new_variable()
        self._started = True
        self._thread = threading.Thread(target=self._former_loop,
                                        daemon=True, name="serving-former")
        self._thread.start()
        if self._decode is not None:
            self._decode.start()
        return self

    def stop(self, drain: bool = True,
             deadline_ms: Optional[float] = None):
        """Stop the server. ``drain=True`` is the graceful path: new
        submits fail at once with code ``shutting_down`` while everything
        already queued is served, up to ``deadline_ms`` (default
        ``MXNET_SERVING_DRAIN_DEADLINE_MS``; unset = drain fully), after
        which still-queued requests fail with ``shutting_down`` too.
        ``drain=False`` fails queued requests right away (``shutdown``).
        In-flight dispatches always finish. Once ``stop`` returns later
        submits raise ``shutdown``."""
        if self._decode is not None:
            # token streams drain (or fail) on the same policy
            self._decode.stop(drain=drain, deadline_ms=deadline_ms)
        if not self._started:
            self._former.close()
            self._former.fail_pending()
            return
        if not drain:
            self._former.close()
            self._former.fail_pending()
            self._thread.join()
        else:
            if deadline_ms is None:
                env = os.environ.get("MXNET_SERVING_DRAIN_DEADLINE_MS", "")
                deadline_ms = float(env) if env else None
            self._former.close(code="shutting_down")
            self._thread.join(None if deadline_ms is None
                              else max(0.0, deadline_ms) / 1e3)
            if self._thread.is_alive():
                # deadline passed: give up on what is still queued
                # (in-flight batches still complete on their vars)
                self._former.fail_pending(
                    code="shutting_down",
                    msg="drain deadline (%g ms) passed with the request "
                        "still queued" % deadline_ms)
                self._thread.join()
            self._former.close(code="shutdown")
        for rep in self._replicas:
            engine.wait_for_var(rep.var)
            engine.untrack_inflight(rep.var)
            engine.delete_variable(rep.var)
            rep.var = None
            # recorded sequences name the deleted var; start() issues a
            # fresh one, so capture warms up again
            rep.captures.clear()
        if self._tuner_var is not None:
            engine.wait_for_var(self._tuner_var)
            engine.delete_variable(self._tuner_var)
            self._tuner_var = None
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # --- client surface ---------------------------------------------------
    def submit(self, timeout_ms: Optional[float] = None,
               priority: object = 0,
               request_id: Optional[str] = None,
               **inputs) -> Request:
        """Enqueue one request (arrays WITH a leading batch axis). Returns a
        Request future; ``req.get()`` blocks for the result. Raises
        ServingError at once on backpressure (``queue_full``), an
        infeasible deadline (``deadline_exceeded``) or shutdown.
        ``priority``: ``"interactive"`` / 0 (default, dispatched first) or
        ``"batch"`` / 1. ``request_id`` rides on the Request and its
        telemetry."""
        pri = {"interactive": 0, "batch": 1}.get(priority, priority)
        rows = None
        feed = {}
        for name in self._input_names:
            if name not in inputs:
                raise ServingError("missing input %r (need %s)"
                                   % (name, self._input_names))
            arr = np.asarray(inputs[name])
            want = self._example_shapes[name]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                raise ServingError(
                    "input %r shape %s != (rows,)+%s"
                    % (name, arr.shape, want))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ServingError("inconsistent row counts across inputs")
            feed[name] = arr
        if rows < 1:
            raise ServingError("empty request")
        max_rows = max(self.config.buckets)
        if rows > max_rows:
            raise ServingError(
                "request of %d rows exceeds the largest bucket (%d)"
                % (rows, max_rows), "too_large")
        t = self.config.timeout_ms if timeout_ms is None else timeout_ms
        deadline = (time.monotonic() + t / 1e3) if t and t > 0 else None
        # the trace context rides ON the request: a thread-local does not
        # survive the former / engine thread hops
        trace = trace_context.current_context()
        req = Request(feed, rows, deadline, priority=pri,
                      request_id=request_id, trace=trace)
        if trace is not None and telemetry.enabled("serving"):
            telemetry.instant("serving.submit", domain="serving", rows=rows,
                              priority=req.priority, **trace.stamps())
        else:
            telemetry.instant("serving.submit", domain="serving", rows=rows,
                              priority=req.priority, request_id=request_id)
        self.metrics.record_submit(rows)
        try:
            self._former.submit(req)
        except ServingError as e:
            self.metrics.record_error(e.code)
            raise
        return req

    def predict(self, timeout_ms: Optional[float] = None,
                **inputs) -> List[np.ndarray]:
        """Synchronous convenience: submit + wait."""
        req = self.submit(timeout_ms=timeout_ms, **inputs)
        # grace over the queue deadline so a request failed by the former
        # surfaces its own (structured) error rather than a wait_timeout
        t = self.config.timeout_ms if timeout_ms is None else timeout_ms
        wait = (t / 1e3 + 60.0) if t and t > 0 else None
        return req.get(wait)

    # --- autoregressive decode (serving/generate) -------------------------
    def submit_stream(self, prompt: Sequence[int],
                      max_new_tokens: Optional[int] = None,
                      timeout_ms: Optional[float] = None,
                      temperature: float = 0.0,
                      seed: Optional[int] = None,
                      request_id: Optional[str] = None) -> TokenStream:
        """Enqueue one generate request; returns a :class:`TokenStream`
        that yields token ids as the continuous-batching scheduler decodes
        them. ``timeout_ms`` is a whole-stream deadline (default none).
        ``temperature`` 0 is greedy; > 0 samples with a ``seed``-seeded
        generator a stream. Raises ServingError with the batcher's codes."""
        if self._decode is None:
            raise ServingError(
                "decode is not configured — construct the server with "
                "decode=GenerateConfig(num_heads=...)")
        if not self._started:
            raise ServingError("server not started", "shutdown")
        trace = trace_context.current_context()
        if trace is not None and telemetry.enabled("serving"):
            telemetry.instant("serving.submit_stream", domain="serving",
                              prompt=len(prompt), **trace.stamps())
        else:
            telemetry.instant("serving.submit_stream", domain="serving",
                              prompt=len(prompt), request_id=request_id)
        try:
            return self._decode.submit(prompt, max_new_tokens,
                                       timeout_ms=timeout_ms,
                                       temperature=temperature, seed=seed,
                                       request_id=request_id, trace=trace)
        except ServingError as e:
            self.metrics.record_error(e.code)
            raise

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 temperature: float = 0.0,
                 seed: Optional[int] = None) -> List[int]:
        """Synchronous convenience: submit_stream + wait for the whole
        token list."""
        stream = self.submit_stream(prompt, max_new_tokens,
                                    timeout_ms=timeout_ms,
                                    temperature=temperature, seed=seed)
        wait = None if timeout_ms is None else timeout_ms / 1e3 + 60.0
        return stream.tokens(wait)

    def decode_stats(self) -> Dict:
        """The decode scheduler's stats (steps, queue, the decode step's
        path a replica, ...)."""
        if self._decode is None:
            raise ServingError("decode is not configured")
        return self._decode.stats()

    # --- former loop + dispatch -------------------------------------------
    def _former_loop(self):
        while True:
            with telemetry.span("serving.form_batch", domain="serving") as sp:
                batch = self._former.next_batch()
                if batch is not None:
                    sp.annotate(n_requests=len(batch))
            if batch is None:
                return
            if telemetry.enabled("serving"):
                # queue time per request: submitted is time.monotonic(),
                # the clock the tracer stamps in
                for r in batch:
                    extra = (r.trace.child().stamps()
                             if r.trace is not None else {})
                    telemetry.complete("serving.queued", domain="serving",
                                       start_ns=int(r.submitted * 1e9),
                                       rows=r.rows, **extra)
            rep = self._pick_replica()
            self._nbatch += 1
            nbatch = self._nbatch
            dispatch = (lambda done, batch=batch, rep=rep, nbatch=nbatch:
                        self._dispatch(batch, rep, nbatch, done))
            if self.config.capture:
                self._push_captured(rep, batch, dispatch, nbatch)
            else:
                engine.push_async(
                    dispatch, mutable_vars=[rep.var],
                    name="serving_dispatch_r%d" % rep.index)
            if (self._tuner is not None and self.config.retune_interval > 0
                    and nbatch % self.config.retune_interval == 0):
                self._push_retune()

    def _push_captured(self, rep: _Replica, batch: List[Request],
                       dispatch: Callable, nbatch: int):
        """Dispatch through the replica's CapturedSequence of the nominal
        bucket (the smallest rung of the current ladder holding the
        batch); ``acquire()`` still picks the real bucket at run time, so
        a ladder swap never strands a request, it only invalidates the
        sequence (``_retune_op``)."""
        ladder = self._ladder  # atomic tuple snapshot
        rows = sum(r.rows for r in batch)
        bucket = next((b for b in ladder if b >= rows), ladder[-1])
        cs = rep.captures.get(bucket)
        if cs is None:
            cs = engine.CapturedSequence(
                name="serving_r%d_b%d" % (rep.index, bucket),
                fuse=True if self.config.fuse else None)
            rep.captures[bucket] = cs
        fuse = (self._fuse_dispatch_op(rep, bucket, batch, nbatch)
                if self.config.fuse else None)
        cs.begin_step()
        cs.push_async(dispatch, mutable_vars=(rep.var,),
                      name="serving_dispatch_r%d" % rep.index, fuse=fuse)
        cs.end_step()

    def _fuse_dispatch_op(self, rep: _Replica, bucket: int,
                          batch: List[Request], nbatch: int):
        """The traceable metadata of one captured dispatch
        (``engine.FuseOp``): the staged computation is the nominal bucket
        Predictor's forward; the feed re-runs ``acquire()`` and the pad on
        the engine worker and bails to replay when it resolves another
        bucket; the writeback publishes the results as ``_dispatch``
        does."""
        exe = rep.cache.prepare(bucket)
        names = list(self._input_names)

        def fwd_fn(*vals, _exe=exe):
            return (tuple(_exe._fused_forward(dict(zip(names, vals)))),)

        def feed(_batch=batch, _exe=exe, _bucket=bucket):
            # a failure here comes before anything is published: as a
            # bail, the iteration replays through _dispatch, whose handler
            # delivers request errors
            try:
                rows = sum(r.rows for r in _batch)
                b, got = rep.cache.acquire(rows)
                if got is not _exe:
                    raise engine._FuseBail(
                        "bucket drift: acquire() resolved b%d, staged b%d"
                        % (b, _bucket))
                fd = self._feed(rep, _batch, b, rows)
                return tuple(fd[n] for n in names)
            except engine._FuseBail:
                raise
            except BaseException as e:
                raise engine._FuseBail("dispatch feed failed: %s: %s"
                                       % (type(e).__name__, e))

        def writeback(d, _batch=batch, _nbatch=nbatch, _bucket=bucket):
            try:
                outs = [_host_tensor(o) for o in d[rep.var]]
                self._publish_outputs(_batch, rep, _nbatch, _bucket,
                                      sum(r.rows for r in _batch), outs)
            except BaseException as e:  # _dispatch's error contract
                err = e if isinstance(e, ServingError) else ServingError(
                    "dispatch failed: %s: %s" % (type(e).__name__, e),
                    "dispatch_error")
                self.metrics.record_error(err.code)
                for r in _batch:
                    if not r.done():
                        r.set_error(err)
                        _flight.request_end(r.trace, ok=False,
                                            code=err.code,
                                            latency_ms=r.latency_ms,
                                            request_id=r.request_id)

        return engine.FuseOp(
            fwd_fn, out_vars=(rep.var,), feed=feed, writeback=writeback,
            fingerprint="serving:b%d:%s:%r" % (bucket, self._dtype, names),
            device=exe._device)

    def capture_stats(self) -> List[Dict[int, Dict]]:
        """Each replica's captured dispatch sequences: {nominal bucket:
        the sequence's stats, with its fused program's runs and graph
        replays}."""
        out = []
        for rep in self._replicas:
            d = {}
            for b, cs in list(rep.captures.items()):
                st = cs.stats()
                prog = cs.fused
                st["fused_program_runs"] = prog.runs if prog else 0
                st["fused_replays"] = prog.replays if prog else 0
                d[b] = st
            out.append(d)
        return out

    def _pick_replica(self) -> _Replica:
        """Routing policy. ``rr``: round-robin. ``least_loaded``: the
        replica with the fewest outstanding engine ops on its var (queued
        + running dispatches, engine.var_inflight); the round-robin start
        index breaks ties so equal-load replicas still rotate."""
        reps = self._replicas
        start = self._rr % len(reps)
        self._rr += 1
        if self.config.router != "least_loaded" or len(reps) == 1:
            return reps[start]
        best, best_load = None, None
        for i in range(len(reps)):
            rep = reps[(start + i) % len(reps)]
            load = engine.var_inflight(rep.var)
            if best_load is None or load < best_load:
                best, best_load = rep, load
        return best

    # --- adaptive ladder retune -------------------------------------------
    def _push_retune(self):
        engine.push(self._retune_op, mutable_vars=[self._tuner_var],
                    name="serving_retune")

    def retune_now(self, wait: bool = True):
        """Run one tuner pass now (the periodic path pushes the same op
        every ``retune_interval`` batches), serialized on the tuner var."""
        if self._tuner is None:
            raise ServingError(
                "adaptive tuning is disabled (ServingConfig.adaptive)")
        if self._tuner_var is None:
            raise ServingError("server is stopped", "shutdown")
        self._push_retune()
        if wait:
            engine.fence([self._tuner_var]).wait()

    def _retune_op(self):
        """One tuner pass (an engine op, off the hot path): propose a
        ladder from the observed size histogram; if it clears the
        hysteresis bar, bind every new bucket ahead, THEN swap each
        replica's ladder atomically and retire old executors LRU. The
        dispatch reads the old ladder until the rebind, and acquire()
        makes choose + fetch atomic against the swap, so no in-flight
        request can fail."""
        try:
            ladder = self._tuner.propose(
                self.metrics.request_size_histogram(), self._ladder)
            if ladder is None:
                return
            with telemetry.span("serving.retune", domain="serving",
                                ladder=str(ladder)):
                for rep in self._replicas:
                    for b in ladder:
                        rep.cache.prepare(b)  # bind BEFORE the swap
                for rep in self._replicas:
                    rep.cache.set_ladder(
                        ladder, budget=self._tuner.program_budget)
                    rep.staging.retain(ladder)
                self._ladder = tuple(ladder)
                self._ladder_version += 1
                # captured dispatch sequences recorded against the old
                # ladder warm up again against the new one; a replay
                # already submitted runs on (acquire() is swap-atomic)
                for rep in self._replicas:
                    for cs in list(rep.captures.values()):
                        cs.invalidate("ladder swap v%d"
                                      % self._ladder_version)
                    rep.captures.clear()
            telemetry.instant("serving.ladder_swap", domain="serving",
                              version=self._ladder_version,
                              ladder=str(ladder))
        except BaseException:
            # a failed retune must never take the serving path down;
            # traffic continues on the current ladder
            _log.exception("serving ladder retune failed (keeping ladder "
                           "%s)", self._ladder)

    def _feed(self, rep: _Replica, batch: List[Request], bucket: int,
              rows: int) -> Dict[str, object]:
        """The bucket's padded inputs: the replica's staging buffers (the
        pinned tensors on a card, one non-blocking copy each), or fresh
        arrays without zero-copy."""
        if self.config.zero_copy:
            # safe: dispatches to this replica serialize on its var, and
            # forward has read its inputs before it returns
            rep.staging.fill(batch, bucket, self._input_names)
            return {n: rep.staging.tensor(bucket, n)
                    for n in self._input_names}
        feed = {}
        for name in self._input_names:
            cat = np.concatenate([r.inputs[name] for r in batch], axis=0)
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + cat.shape[1:], cat.dtype)
                cat = np.concatenate([cat, pad], axis=0)
            feed[name] = cat
        return feed

    def _dispatch(self, batch: List[Request], rep: _Replica, nbatch: int,
                  on_complete: Callable[[], None]):
        # entered/exited by hand so the span brackets the whole dispatch
        # (success and failure) without nesting the handler
        sp = telemetry.span("serving.dispatch", domain="serving",
                            nbatch=nbatch, replica=rep.index)
        sp.__enter__()
        t0 = time.monotonic()
        try:
            rows = sum(r.rows for r in batch)
            # choose and fetch under one cache lock hold: atomic against a
            # concurrent ladder swap
            bucket, exe = rep.cache.acquire(rows)
            if telemetry.enabled("serving"):
                now = time.monotonic()
                margins = [(r.deadline - now) * 1e3 for r in batch
                           if r.deadline is not None]
                sp.annotate(bucket=bucket, rows=rows,
                            deadline_margin_ms=(round(min(margins), 3)
                                                if margins else None))
                # link every member request's trace, so each request's
                # tree includes the batch it rode
                tids = [r.trace.trace_id for r in batch
                        if r.trace is not None]
                if tids:
                    sp.annotate(trace_ids=tids,
                                span_id=trace_context.mint_span_id())
            with telemetry.span("serving.pad", domain="serving",
                                bucket=bucket, rows=rows):
                feed = self._feed(rep, batch, bucket, rows)
            with telemetry.span("serving.forward", domain="serving",
                                bucket=bucket):
                outs = [_host(o) for o in exe.forward(**feed)]
            self._publish_outputs(batch, rep, nbatch, bucket, rows, outs)
            # the reject-early estimator's service time (handoff to
            # results published), successes only
            self._former.note_dispatch(time.monotonic() - t0)
        except BaseException as e:
            err = e if isinstance(e, ServingError) else ServingError(
                "dispatch failed: %s: %s" % (type(e).__name__, e),
                "dispatch_error")
            self.metrics.record_error(err.code)
            for r in batch:
                if not r.done():
                    r.set_error(err)
                    _flight.request_end(r.trace, ok=False, code=err.code,
                                        latency_ms=r.latency_ms,
                                        request_id=r.request_id)
        finally:
            sp.__exit__(None, None, None)
            on_complete()

    def _publish_outputs(self, batch: List[Request], rep: _Replica,
                         nbatch: int, bucket: int, rows: int, outs):
        """Post-forward publication: the batch-axis check, per-request
        result slicing, metrics and the batch_end_callback. Raises on a
        contract violation; the caller delivers the error."""
        outs = [np.asarray(o) for o in outs]
        for o in outs:
            if o.shape[:1] != (bucket,):
                raise ServingError(
                    "output batch axis %s != bucket %d — serving "
                    "requires batch-major outputs" % (o.shape, bucket))
        offset = 0
        lats = []
        for r in batch:
            r.set_result([o[offset:offset + r.rows] for o in outs])
            offset += r.rows
            lats.append(r.latency_ms)
            self.metrics.observe_latency(
                r.latency_ms,
                r.trace.trace_id if r.trace is not None else None)
            _flight.request_end(r.trace, ok=True, latency_ms=r.latency_ms,
                                kind="predict", request_id=r.request_id)
        rep.dispatched += 1
        self.metrics.record_batch(rows, bucket, lats)
        if self._batch_end_callback is not None:
            # every request already completed: a raising user callback
            # must not be recorded as a dispatch failure
            try:
                self._batch_end_callback(ServingBatchEndParam(
                    nbatch=nbatch, bucket=bucket, rows=rows,
                    replica=rep.index,
                    latency_ms=sum(lats) / len(lats), occupancy=rows,
                    metrics=self.metrics))
            except Exception:
                _log.exception("serving batch_end_callback raised (batch "
                               "%d)", nbatch)

    # --- readiness --------------------------------------------------------
    def warm(self):
        """Bind every rung of every replica's ladder now. Idempotent."""
        for rep in self._replicas:
            rep.cache.warm()

    def ready(self) -> bool:
        """True once the server is started AND every replica holds an
        executor for every rung of the live ladder: traffic admitted now
        will not wait on a bind."""
        if not self._started:
            return False
        for rep in self._replicas:
            s = rep.cache.stats()
            if not set(s["buckets"]) <= set(s["compiled"]):
                return False
        return True

    # --- introspection ----------------------------------------------------
    def get_metrics(self):
        """metric.py-style (names, values) snapshot."""
        return self.metrics.get()

    def cache_stats(self) -> Dict:
        return self._cache_stats()

    def replica_dispatch_counts(self) -> List[int]:
        return [rep.dispatched for rep in self._replicas]

    def current_ladder(self) -> tuple:
        """The live bucket ladder (changes under adaptive tuning)."""
        return self._ladder

    @property
    def ladder_version(self) -> int:
        """0 for the static ladder; +1 per adaptive swap."""
        return self._ladder_version

    def router_inflight(self) -> List[int]:
        """Per-replica outstanding engine-op counts (the router's view)."""
        return self._router_inflight()


def create_server(prefix: str, epoch: int, example_shapes: Dict[str, tuple],
                  dtype: str = "float32", **kwargs) -> InferenceServer:
    """A server straight from a training checkpoint pair (the
    ``predict.create`` analogue): ``prefix-symbol.json`` +
    ``prefix-%04d.params``."""
    return InferenceServer("%s-symbol.json" % prefix,
                           "%s-%04d.params" % (prefix, epoch),
                           example_shapes, dtype=dtype, **kwargs)
