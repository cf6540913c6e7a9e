"""Orca-style iteration-level scheduler for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/generate/scheduler.py``. One scheduler
thread drives every replica's KV cache: each loop iteration it (1)
expires/admits waiting prompts, each into the replica with the most free
slots — each admission is one engine op on that replica's kv var:
unpaged, a prefill through the flash-attention kernel plus an admit into
the slot row; paged, one paged prefill (copy-on-write fork + attention
over the cached prefix + the suffix's scatter into its blocks) — (2)
pushes ONE fixed-shape decode step over all slots of each occupied
replica onto the engine (``mutable_vars=[kv var]``, so the engine orders
step N+1 after step N and after any admits between them), (3) fences,
samples on the host, streams tokens out, and retires finished sequences.
The batch is re-formed every step as sequences finish and new ones join
mid-flight.

Replicas (``replicas``, the ``InferenceServer``'s replica count): each
has its own KV cache manager (slot rows or block pool) and its own decode
step (``DecodePrograms.replica``), so its own CUDA graph when captured;
the prefill programs are shared. The gauges sum (blocks, bytes) or
average (occupancy) over replicas.

Paged KV (``paged=True``: ``block_tokens``, ``num_blocks``,
``prefix_share``) drives ``PagedDecodePrograms`` + ``PagedKVCacheManager``:
admission reserves blocks and reuses shared prompt prefixes, and the
decode step carries each row's block table. ``kv_dtype="int8"`` stores
the cache quantized with per-position scale slabs; ``capture=True`` runs
the decode step (and the verify) as one CUDA graph on the card (eagerly
on the CPU).

Weight quantization (``quant_weights`` int8 | fp8, ``MXNET_QUANT_*``)
quantizes the model at construction (``mxnet_tpu_torch.quant``).
Speculative decoding (``spec``, ``spec_tokens``, ``spec_draft``:
``MXNET_DECODE_SPEC``, ``MXNET_DECODE_SPEC_TOKENS``, default 4,
``MXNET_DECODE_SPEC_DRAFT``, default int8) replaces the decode step with
``spec.SpecDecoder``'s iteration: k draft steps of the int8-quantized
target (``int8``) or of the target itself (``self``), one verify, host
acceptance; a stream emits 1..k+1 tokens an iteration.

The scheduler's ``_cond`` is never held across an engine push or fence;
``TokenStream._cond`` and the cache managers' ``_lock`` are leaves taken
under it.

Telemetry, under the reference's names (domain ``serving``): the spans
``serving.queued`` (submit to admission), ``decode.prefill`` (with
``decode.cow_fork`` inside a paged prefill that forks), ``serving.dispatch``
(push to first token) and, a scheduler step, ``decode.step`` with every
co-resident stream's ``trace_ids``. The step span runs on the engine
worker around the step and the read of its logits, the read the step
already waits on, so it covers the device's work; with the step captured
it wraps the host side of the replay, never the captured body. The
registry's counters and gauges (tokens, occupancy, KV bytes, pool blocks,
prefix reuse, accept rate, tokens a step) are set by the scheduler loop,
never read through a callback, so a second scheduler in the process never
reads a dead one's values; each scheduler's ``start`` sets its own. A
finished stream feeds ``serving_request_latency_ms`` (its trace id the
exemplar) and the flight recorder, and a deadline miss writes a flight
bundle. A stream's trace is the ``trace`` given to :meth:`submit`, else
the submitting thread's ``telemetry.context.current_context()``.

Engine capture (``capture=True`` or ``MXNET_ENGINE_CAPTURE``): each
replica's decode step rides a ``CapturedSequence`` named
``decode_step_r<replica>``: eager for the warm-up steps, then one replayed
engine submission a step (the step itself, captured, is still one CUDA
graph replay); :meth:`DecodeScheduler.engine_capture_stats` reads its
replays and bails.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import engine as _engine
from ... import quant as _quant
from ... import telemetry as _telemetry
from ...telemetry import context as _trace_context
from ...telemetry import flight as _flight
from ..batcher import ServingError
from ..metrics import latency_histogram as _latency_histogram
from .kv_cache import KVCacheManager
from .model import DecodeModel
from .paged import PagedKVCacheManager
from .programs import DecodePrograms, PagedDecodePrograms
from .spec import SpecDecoder, sample_token
from .stream import TokenStream

#: speculative drafts: the target quantized to int8, or the target itself
SPEC_DRAFTS = ("int8", "self")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_flag(name, default):
    return os.environ.get(name, default).lower() \
        not in ("0", "", "false", "off")


def _env_buckets():
    raw = os.environ.get("MXNET_DECODE_PREFILL_BUCKETS", "8,16,32")
    try:
        return tuple(sorted({int(b) for b in raw.split(",") if b.strip()}))
    except ValueError:
        return (8, 16, 32)


def _env_eos():
    raw = os.environ.get("MXNET_DECODE_EOS", "")
    try:
        return int(raw) if raw.strip() else None
    except ValueError:
        return None


@dataclasses.dataclass
class GenerateConfig:
    """Decode-side knobs; every default reads its ``MXNET_DECODE_*`` env
    var at construction time, with the reference's names and defaults.
    Head counts are architecture facts of the checkpoint. ``num_blocks``
    0 sizes the paged pool to the unpaged slabs' positions: ``slots *
    ceil(max_context / block_tokens)``. ``quant_weights`` "" is off;
    ``spec_tokens`` is k, the drafts an iteration; ``spec_draft`` "int8"
    or "self"."""
    num_heads: int
    num_kv_heads: int = 0
    slots: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_SLOTS", 4))
    max_context: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_MAX_CONTEXT", 64))
    prefill_buckets: Tuple[int, ...] = dataclasses.field(
        default_factory=_env_buckets)
    max_new_tokens: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_MAX_NEW_TOKENS", 32))
    queue_depth: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_QUEUE_DEPTH", 64))
    eos_id: Optional[int] = dataclasses.field(default_factory=_env_eos)
    capture: bool = dataclasses.field(
        default_factory=lambda: _env_flag("MXNET_DECODE_CAPTURE", "0"))
    rope_base: float = 10000.0
    paged: bool = dataclasses.field(
        default_factory=lambda: _env_flag("MXNET_DECODE_PAGED", "0"))
    block_tokens: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_BLOCK_TOKENS", 16))
    num_blocks: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_BLOCKS", 0))
    prefix_share: bool = dataclasses.field(
        default_factory=lambda: _env_flag("MXNET_DECODE_PREFIX_SHARE", "1"))
    kv_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_DECODE_KV_DTYPE", "f32"))
    quant_weights: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_QUANT_WEIGHT_DTYPE", ""))
    spec: bool = dataclasses.field(
        default_factory=lambda: _env_flag("MXNET_DECODE_SPEC", "0"))
    spec_tokens: int = dataclasses.field(
        default_factory=lambda: _env_int("MXNET_DECODE_SPEC_TOKENS", 4))
    spec_draft: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_DECODE_SPEC_DRAFT", "int8"))


class _Active:
    """One sequence occupying a slot, with its sampling context
    (temperature 0 = greedy; a private RandomState per stream keeps draws
    deterministic per seed and independent of co-resident streams)."""
    __slots__ = ("stream", "replica", "slot", "last_token", "generated",
                 "temperature", "rng")

    def __init__(self, stream, replica, slot, last_token, generated,
                 temperature=0.0, rng=None):
        self.stream = stream
        self.replica = replica
        self.slot = slot
        self.last_token = last_token
        self.generated = generated
        self.temperature = temperature
        self.rng = rng


class DecodeScheduler:
    """Continuous-batching decode over one model across ``replicas`` KV
    caches (slot rows or block pools) on the model's device."""

    def __init__(self, model: DecodeModel, config: GenerateConfig,
                 replicas: int = 1):
        self.config = config
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ServingError("decode: replicas must be >= 1")
        self.kv_dtype = _quant.normalize_kv_dtype(config.kv_dtype)
        if config.quant_weights and "wq_scale" not in model.params:
            model = _quant.quantize_decode_model(
                model, _quant.QuantConfig(weight_dtype=config.quant_weights))
        self.model = model
        draft = None
        if config.spec:
            if config.spec_tokens < 1:
                raise ServingError("decode: spec_tokens must be >= 1")
            if config.spec_draft not in SPEC_DRAFTS:
                raise ServingError(
                    "decode: unknown spec_draft %r (want int8|self)"
                    % config.spec_draft)
            if config.spec_draft == "int8" \
                    and "wq_scale" not in model.params:
                draft = _quant.quantize_decode_model(
                    model, _quant.QuantConfig(weight_dtype="int8"))
            else:
                # "self", or a target already quantized: the draft is the
                # target, and its step is the vanilla decode step
                draft = model
        if config.paged:
            blocks = config.num_blocks or config.slots * (
                -(-config.max_context // config.block_tokens))
            self.programs: DecodePrograms = PagedDecodePrograms(
                model, config.slots, config.max_context,
                config.prefill_buckets, config.block_tokens, blocks,
                kv_dtype=self.kv_dtype, capture=config.capture,
                step_model=draft)
        else:
            self.programs = DecodePrograms(
                model, config.slots, config.max_context,
                config.prefill_buckets, kv_dtype=self.kv_dtype,
                capture=config.capture, step_model=draft)
        self._spec: Optional[SpecDecoder] = None
        if config.spec:
            self.programs.enable_verify(config.spec_tokens + 1)
            self._spec = SpecDecoder(self)
        # a program set a replica: replica 0's is ``programs``
        self._programs = [self.programs] + [
            self.programs.replica() for _ in range(self.replicas - 1)]
        # KVCacheManager | PagedKVCacheManager, one a replica, from start()
        self.caches: List = []
        self._captures: List[Optional[_engine.CapturedSequence]] = []
        self._cond = threading.Condition()
        self._queue: deque = deque()   # (stream, prompt, temperature, rng)
        # (replica, slot) -> sequence
        self._active: Dict[Tuple[int, int], _Active] = {}
        self._state = "stopped"        # running|draining|stopped
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.replica_steps = [0] * self.replicas   # steps each replica took
        # speculative accounting (spec off: drafted stays 0 and
        # step_tokens == seq_steps, one token a step)
        self.seq_steps = 0        # per-sequence step iterations
        self.step_tokens = 0      # tokens emitted by step iterations
        self.drafted_tokens = 0   # draft lanes that could be accepted
        self.accepted_tokens = 0  # draft lanes the target accepted
        reg = _telemetry.registry
        kv = self.kv_dtype
        self._m_tokens = reg.counter(
            "decode_tokens_total", help="tokens emitted by decode streams")
        # gauges are get-or-create and process-wide: set explicitly (never
        # fn=), so no callback outlives this scheduler
        self._m_occ = reg.gauge(
            "decode_batch_occupancy_pct",
            help="decode slots occupied, % (mean over replicas)")
        self._m_kv = reg.gauge(
            "kv_bytes", help="bytes held in decode KV slabs")
        self._m_kv_dtype = reg.gauge(
            "kv_bytes", labels={"dtype": kv},
            help="bytes held in decode KV slabs")
        self._m_blocks_free = reg.gauge(
            "kv_blocks_free", labels={"decode_kv_dtype": kv},
            help="free KV blocks in the paged pool (sum over replicas)")
        self._m_blocks_total = reg.gauge(
            "kv_blocks_total", labels={"decode_kv_dtype": kv},
            help="usable KV blocks in the paged pool (sum over replicas)")
        self._m_prefix_hits = reg.counter(
            "decode_prefix_hits_total",
            help="admissions that reused a shared KV prefix")
        self._m_prefix_saved = reg.counter(
            "decode_prefix_tokens_saved_total",
            help="prompt tokens served from shared prefix blocks "
                 "instead of being re-prefilled")
        self._m_accept_rate = reg.gauge(
            "decode_spec_accept_rate",
            help="speculative drafts accepted by the target model, "
                 "fraction of drafted tokens (0 when spec is off)")
        self._m_tokens_per_step = reg.gauge(
            "decode_tokens_per_step",
            help="tokens emitted per sequence per decode iteration "
                 "(vanilla decode: exactly 1.0)")

    # --- lifecycle --------------------------------------------------------
    def start(self):
        with self._cond:
            if self._state != "stopped":
                return
            self._state = "running"
        if self.config.paged:
            self.caches = [
                PagedKVCacheManager(p, prefix_share=self.config.prefix_share)
                for p in self._programs]
            self._m_blocks_total.set(
                sum(c.blocks_total() for c in self.caches))
            self._m_blocks_free.set(
                sum(c.blocks_free() for c in self.caches))
        else:
            self.caches = [KVCacheManager(p) for p in self._programs]
            self._m_blocks_total.set(0)
            self._m_blocks_free.set(0)
        use_capture = self.config.capture or _engine.capture_enabled()
        self._captures = [
            _engine.CapturedSequence(name="decode_step_r%d" % i)
            if use_capture else None for i in range(self.replicas)]
        kv_total = sum(c.kv_bytes() for c in self.caches)
        self._m_kv.set(kv_total)
        self._m_kv_dtype.set(kv_total)
        # this scheduler's values from its start: a gauge an earlier
        # scheduler set must not read as this one's
        self._m_occ.set(0.0)
        self._m_accept_rate.set(0.0)
        self._m_tokens_per_step.set(0.0)
        self._thread = threading.Thread(target=self._loop,
                                        name="decode-scheduler", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False, deadline_ms: Optional[float] = None):
        """Stop the scheduler. ``drain=True`` finishes in-flight and queued
        streams first (refusing new submits, code ``shutting_down``);
        ``drain=False`` fails everything immediately (code ``shutdown``)."""
        with self._cond:
            if self._state == "stopped" and self._thread is None:
                return
            self._state = "draining" if drain else "stopped"
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            timeout = None if deadline_ms is None else deadline_ms / 1000.0
            t.join(timeout)
            if t.is_alive():
                # drain deadline passed: force the loop out
                with self._cond:
                    self._state = "stopped"
                    self._cond.notify_all()
                t.join()
        self._thread = None
        code = "shutting_down" if drain else "shutdown"
        leftovers: List[TokenStream] = []
        with self._cond:
            self._state = "stopped"
            while self._queue:
                leftovers.append(self._queue.popleft()[0])
            actives, self._active = list(self._active.values()), {}
        for a in actives:
            self.caches[a.replica].free(a.slot)
            leftovers.append(a.stream)
        for s in leftovers:
            s._fail(ServingError("decode scheduler stopped", code=code))
        for cs in self._captures:
            if cs is not None:
                cs.invalidate("scheduler stopped")
        if self.caches:
            _engine.fence([c.var for c in self.caches]).wait()
            for c in self.caches:
                _engine.untrack_inflight(c.var)
                _engine.delete_variable(c.var)
        self.caches = []
        self._m_occ.set(0.0)

    # --- submission -------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               timeout_ms: Optional[float] = None,
               temperature: float = 0.0,
               seed: Optional[int] = None,
               request_id: Optional[str] = None,
               trace=None) -> TokenStream:
        """Queue one prompt. ``temperature`` 0 (default) is greedy; > 0
        samples from the softmax with a per-stream RandomState seeded by
        ``seed``. ``request_id`` rides on the TokenStream and on the
        decode spans; ``trace`` (else the thread's current trace context)
        stamps the stream's spans and its flight record."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ServingError("empty prompt", code="too_large")
        if self.programs.bucket_for(len(prompt)) is None:
            raise ServingError(
                "prompt length %d exceeds largest prefill bucket %d"
                % (len(prompt), self.programs.buckets[-1]), code="too_large")
        if len(prompt) >= self.programs.capacity:
            raise ServingError(
                "prompt length %d leaves no kv capacity (max_context %d)"
                % (len(prompt), self.programs.capacity), code="too_large")
        max_new = int(max_new_tokens or self.config.max_new_tokens)
        if max_new < 1:
            raise ServingError("max_new_tokens must be >= 1",
                               code="too_large")
        deadline = None if timeout_ms is None \
            else time.monotonic() + timeout_ms / 1000.0
        stream = TokenStream(len(prompt), max_new, deadline,
                             request_id=request_id,
                             trace=(trace if trace is not None else
                                    _trace_context.current_context()))
        temperature = float(temperature)
        rng = np.random.RandomState(seed) if temperature > 0.0 else None
        with self._cond:
            if self._state == "draining":
                raise ServingError("server is draining",
                                   code="shutting_down")
            if self._state != "running":
                raise ServingError("decode scheduler not running",
                                   code="shutdown")
            if len(self._queue) >= self.config.queue_depth:
                raise ServingError("decode queue full", code="queue_full")
            self._queue.append((stream, prompt, temperature, rng))
            self._cond.notify_all()
        return stream

    # --- scheduler loop ---------------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while (self._state == "running" and not self._queue
                       and not self._active):
                    self._cond.wait(0.1)
                if self._state == "stopped":
                    return
                if (self._state == "draining" and not self._queue
                        and not self._active):
                    return
            self._expire_and_cancel()
            self._admit_waiting()
            self._step_all()
            caches = self.caches
            self._m_occ.set(sum(c.occupancy_pct() for c in caches)
                            / len(caches))
            if self.config.paged:
                self._m_blocks_free.set(sum(c.blocks_free() for c in caches))
            if self.seq_steps:
                self._m_tokens_per_step.set(
                    self.step_tokens / self.seq_steps)
            if self.drafted_tokens:
                self._m_accept_rate.set(
                    self.accepted_tokens / self.drafted_tokens)

    def _expire_and_cancel(self):
        now = time.monotonic()
        expired: List[TokenStream] = []
        cancelled: List[TokenStream] = []
        with self._cond:
            keep: deque = deque()
            for item in self._queue:
                s = item[0]
                if s.cancelled:
                    cancelled.append(s)
                elif s.deadline is not None and now > s.deadline:
                    expired.append(s)
                else:
                    keep.append(item)
            self._queue = keep
        for s in cancelled:
            s._finish("cancelled")
            self._stream_end(s, ok=True, code="cancelled")
        for s in expired:
            s._fail(ServingError("expired before a decode slot freed",
                                 code="deadline_exceeded"))
            self._stream_end(s, ok=False, code="deadline_exceeded",
                             queued=True)
        # active sequences: retire cancelled/expired before the next step
        for a in list(self._active.values()):
            if a.stream.cancelled:
                self._retire(a, reason="cancelled")
            elif a.stream.deadline is not None and now > a.stream.deadline:
                self._retire(a, error=ServingError(
                    "deadline exceeded mid-stream",
                    code="deadline_exceeded"))

    def _stream_end(self, stream: TokenStream, ok: bool,
                    code: Optional[str] = None, queued: bool = False):
        """Observability tail of one finished stream: the registry's
        latency histogram (the trace id its exemplar), the flight
        recorder's completed-request ring, and the deadline-miss bundle.
        Called with no scheduler lock held."""
        lat_ms = (time.monotonic() - stream.submitted) * 1e3
        tr = stream.trace
        if queued and tr is not None and _telemetry.enabled("serving"):
            # a stream that died waiting never got its queued span: stamp
            # one now, so its flight timeline is whole
            _telemetry.complete("serving.queued", domain="serving",
                                start_ns=int(stream.submitted * 1e9),
                                tokens=stream.prompt_len, error=code,
                                **tr.child().stamps())
        if ok:
            _latency_histogram().observe(
                lat_ms, exemplar=tr.trace_id if tr is not None else None)
        _flight.request_end(tr, ok=ok, code=code, latency_ms=lat_ms,
                            kind="generate", request_id=stream.request_id)
        if code == "deadline_exceeded":
            _flight.on_anomaly("deadline_miss", tr,
                               request_id=stream.request_id,
                               latency_ms=lat_ms, kind="generate")

    def _retire(self, a: _Active, reason: Optional[str] = None,
                error: Optional[ServingError] = None):
        self.caches[a.replica].free(a.slot)
        with self._cond:
            self._active.pop((a.replica, a.slot), None)
        if error is not None:
            a.stream._fail(error)
            self._stream_end(a.stream, ok=False, code=error.code)
        else:
            a.stream._finish(reason or "eos")
            self._stream_end(a.stream, ok=True, code=reason or "eos")

    def _pick_replica(self) -> Optional[int]:
        """The replica with the most free slots (the first on a tie), or
        None when every slot is taken."""
        best, best_free = None, 0
        for i, c in enumerate(self.caches):
            free = c.slots - len(c.active_slots())
            if free > best_free:
                best, best_free = i, free
        return best

    def _admit_waiting(self):
        """Prefill waiting prompts into free slots (unpaged) / free blocks
        (paged) of the replica with the most free slots. Each admission is
        one engine op on that replica's kv var (prefill -> slot insert;
        paged: the one paged prefill, which may run only the suffix after
        a shared prefix and fork a shared boundary block first), fenced as
        a group so fresh sequences join the very next step. A traced stream's ``serving.queued`` span closes here; its
        ``serving.dispatch`` span runs from the push to its first token,
        the parent of the ``decode.prefill`` span the engine worker
        records."""
        admitted = []         # (active, holder, dispatch context, push ns)
        touched = []
        while True:
            rep = self._pick_replica()
            if rep is None:
                break
            with self._cond:
                if not self._queue:
                    break
                stream, prompt, temp, rng = self._queue.popleft()
            cache = self.caches[rep]
            plan = cache.try_admit(stream, prompt, stream.max_new_tokens)
            if plan is None:      # slots/blocks exhausted — wait for
                with self._cond:  # retirement, never evict mid-stream
                    self._queue.appendleft((stream, prompt, temp, rng))
                break
            # build the bucket's prefill program here (scheduler thread)
            # so the engine op never mutates the program dict
            self.programs.ensure_prefill(len(plan.suffix))
            if plan.ctx_len:
                self._m_prefix_hits.inc()
                self._m_prefix_saved.inc(plan.ctx_len)
            tr = stream.trace
            dctx, stamps = None, {"request_id": stream.request_id}
            if tr is not None and _telemetry.enabled("serving"):
                _telemetry.complete("serving.queued", domain="serving",
                                    start_ns=int(stream.submitted * 1e9),
                                    tokens=len(prompt),
                                    **tr.child().stamps())
                dctx = tr.child()
                stamps = dctx.child().stamps()
            holder: Dict[str, object] = {}
            admitted.append((_Active(stream, rep, plan.slot, 0, 0,
                                     temperature=temp, rng=rng), holder,
                             dctx, _telemetry.clock_ns()))
            if cache.var not in touched:
                touched.append(cache.var)

            def op(plan=plan, holder=holder, stamps=stamps, cache=cache):
                progs = self.programs
                args = dict(tokens=len(plan.suffix), **stamps)
                if self.config.paged:
                    args["reused"] = plan.ctx_len
                try:
                    with _telemetry.span("decode.prefill", domain="serving",
                                         **args):
                        if not self.config.paged:
                            last, *kv_new = progs.prefill(plan.suffix)
                            if len(kv_new) == 4:    # int8 KV: + scale rows
                                progs.admit(cache.k_slab, cache.v_slab,
                                            kv_new[0], kv_new[1], plan.slot,
                                            ks_slab=cache.k_scale,
                                            vs_slab=cache.v_scale,
                                            ks_new=kv_new[2],
                                            vs_new=kv_new[3])
                            else:
                                progs.admit(cache.k_slab, cache.v_slab,
                                            kv_new[0], kv_new[1], plan.slot)
                        elif plan.forked:
                            with _telemetry.span(
                                    "decode.cow_fork", domain="serving",
                                    src=plan.fork_src, dst=plan.fork_dst):
                                last = self._paged_prefill(cache, plan)
                        else:
                            last = self._paged_prefill(cache, plan)
                        holder["logits"] = last.float().cpu().numpy()
                except Exception as e:      # noqa: BLE001 — reported below
                    holder["error"] = e

            _engine.push(op, mutable_vars=[cache.var], name="decode.prefill")
        if not admitted:
            return
        _engine.fence(touched).wait()
        for a, holder, dctx, t0 in admitted:
            err = holder.get("error")
            if err is not None:
                self.caches[a.replica].free(a.slot)
                a.stream._fail(ServingError(
                    "prefill failed: %s" % err, code="dispatch_error"))
                self._stream_end(a.stream, ok=False, code="dispatch_error")
                continue
            if dctx is not None:
                _telemetry.complete("serving.dispatch", domain="serving",
                                    start_ns=t0, kind="prefill",
                                    replica=a.replica, **dctx.stamps())
            with self._cond:
                self._active[(a.replica, a.slot)] = a
            self._emit(a, sample_token(holder["logits"], a.temperature,
                                       a.rng))

    def _paged_prefill(self, cache, plan):
        """The paged prefill of ``plan`` into ``cache`` (engine worker):
        the copy-on-write fork, attention over the cached prefix and the
        suffix's scatter, in place; returns the last position's logits."""
        return self.programs.paged_prefill(
            cache.k_slab, cache.v_slab, plan.table, plan.ctx_len,
            plan.suffix, plan.fork_src, plan.fork_dst,
            ks_slab=cache.k_scale, vs_slab=cache.v_scale)

    def _emit(self, a: _Active, token: int,
              length: Optional[int] = None) -> bool:
        """Deliver one sampled token; retire the sequence if done and
        return False once it has retired (the speculative path then stops
        emitting its window). ``length`` is the kv length after this
        token's predecessor landed: speculative emits pass it, because the
        cache already holds the whole accepted run."""
        a.last_token = token
        a.generated += 1
        a.stream._emit(token)
        self._m_tokens.inc()
        eos = self.config.eos_id
        if eos is not None and token == eos:
            self._retire(a, reason="eos")
            return False
        if a.generated >= a.stream.max_new_tokens:
            self._retire(a, reason="max_tokens")
            return False
        if length is None:
            length = self.caches[a.replica].length(a.slot)
        if length >= self.programs.capacity:
            # the next step would write at kv position == capacity (the
            # write position IS the current length)
            self._retire(a, reason="capacity")
            return False
        return True

    def _step_all(self):
        """One decode step on every replica with occupied slots: push each
        replica's step op, fence them together, then sample/stream on the
        host. With ``spec`` the iteration is ``SpecDecoder``'s (the same
        push / fence / emit, 1..k+1 tokens a sequence)."""
        if self._spec is not None:
            self._spec.step_all()
            return
        with self._cond:
            by_rep: Dict[int, List[_Active]] = {}
            for (rep, _slot), a in sorted(self._active.items()):
                by_rep.setdefault(rep, []).append(a)
        stepped = []          # (replica, [active...], holder)
        for rep, actives in sorted(by_rep.items()):
            cache = self.caches[rep]
            lengths = np.zeros(cache.slots, np.int64)
            tokens = np.zeros(cache.slots, np.int64)
            for a in actives:
                lengths[a.slot] = cache.length(a.slot)
                tokens[a.slot] = a.last_token
            # paged rows read and write kv through their block tables
            # (freed rows are all-trash: they write block 0 and read
            # nothing unmasked)
            tables = cache.step_arrays()[1] if self.config.paged else None
            holder: Dict[str, object] = {}
            stepped.append((rep, actives, holder))
            # batch-level span: every co-resident stream's trace, so each
            # request's tree shows the steps it shared
            stamps = {}
            if _telemetry.enabled("serving"):
                tids = [a.stream.trace.trace_id for a in actives
                        if a.stream.trace is not None]
                if tids:
                    stamps = {"trace_ids": tids,
                              "span_id": _trace_context.mint_span_id()}

            def op(cache=cache, lengths=lengths, tokens=tokens,
                   tables=tables, holder=holder, stamps=stamps):
                scales = {"ks_slab": cache.k_scale, "vs_slab": cache.v_scale}
                progs = cache.programs
                try:
                    # the host side of the step (a replay, when captured)
                    # and the read of its logits, which waits for the card
                    with _telemetry.span("decode.step", domain="serving",
                                         rows=int((lengths > 0).sum()),
                                         **stamps):
                        if tables is not None:
                            logits = progs.decode(
                                cache.k_slab, cache.v_slab, tables, lengths,
                                tokens, **scales)
                        else:
                            logits = progs.decode(
                                cache.k_slab, cache.v_slab, lengths, tokens,
                                **scales)
                        holder["logits"] = logits.float().cpu().numpy()
                except Exception as e:      # noqa: BLE001 — reported below
                    holder["error"] = e

            cs = self._captures[rep] if rep < len(self._captures) else None
            if cs is not None:
                cs.begin_step()
                cs.push(op, mutable_vars=[cache.var], name="decode.step")
                cs.end_step()
            else:
                _engine.push(op, mutable_vars=[cache.var],
                             name="decode.step")
        if not stepped:
            return
        _engine.fence([self.caches[rep].var for rep, _, _ in stepped]).wait()
        self.steps += 1
        for rep, actives, holder in stepped:
            self.replica_steps[rep] += 1
            cache = self.caches[rep]
            err = holder.get("error")
            if err is not None:
                # a failed in-place step may leave the slabs half written:
                # rebuild the replica's cache (and recapture) rather than
                # step on that state
                for a in actives:
                    self._retire(a, error=ServingError(
                        "decode step failed: %s" % err,
                        code="dispatch_error"))
                cache.reset()
                continue
            logits = holder["logits"]
            for a in actives:
                cache.advance(a.slot)
                self.seq_steps += 1
                self.step_tokens += 1
                self._emit(a, sample_token(logits[a.slot], a.temperature,
                                           a.rng))

    # --- introspection ----------------------------------------------------
    def engine_capture_stats(self) -> List[Optional[Dict[str, object]]]:
        """Each replica's ``decode_step_r<i>`` engine sequence (its state,
        replays and bails), None where engine capture is off."""
        return [cs.stats() if cs is not None else None
                for cs in self._captures]

    def capture_stats(self) -> List[Dict[str, object]]:
        """Each replica's decode-step path (``DecodePrograms.capture_stats``
        of its program set) and the steps it took."""
        return [dict(p.capture_stats(), steps=n)
                for p, n in zip(self._programs, self.replica_steps)]

    def stats(self) -> Dict[str, object]:
        """Steps, queue and batch, the KV type and bytes (all replicas),
        the weights' quantization, the speculative counters and accept
        rate, the decode step's path with its warm-up calls, captures and
        replays (summed over replicas; each replica's under ``"replica"``
        when there are several; with spec, the verify's too), and (paged)
        the pools and the prefix counters, summed; with engine capture,
        each replica's sequence under ``"engine_capture"``."""
        with self._cond:
            queued = len(self._queue)
            active = len(self._active)
        caps = self.capture_stats()
        cap = caps[0]
        st = {"steps": self.steps, "queued": queued, "active": active,
              "replicas": self.replicas,
              "kv_dtype": self.kv_dtype,
              "kv_bytes": self.programs.kv_bytes() * self.replicas,
              "quant_weights": self.config.quant_weights or "off",
              "seq_steps": self.seq_steps,
              "step_tokens": self.step_tokens,
              "drafted_tokens": self.drafted_tokens,
              "accepted_tokens": self.accepted_tokens,
              # the reference's decode_spec_accept_rate and
              # decode_tokens_per_step gauges
              "decode_spec_accept_rate": (
                  self.accepted_tokens / self.drafted_tokens
                  if self.drafted_tokens else 0.0),
              "decode_tokens_per_step": (
                  self.step_tokens / self.seq_steps
                  if self.seq_steps else 0.0),
              "spec": "%s k=%d" % (self.config.spec_draft,
                                   self.config.spec_tokens)
              if self.config.spec else "off",
              "decode_path": cap["path"]}
        for k in ("warmup_calls", "captures", "replays"):
            st[k] = sum(c[k] for c in caps)
        if "verify" in cap:
            for k, v in cap["verify"].items():
                if k == "path":
                    st["verify_path"] = v
                elif k != "eager_calls":
                    st["verify_" + k] = sum(c["verify"][k] for c in caps)
        if self.replicas > 1:
            st["replica"] = caps
        if any(cs is not None for cs in self._captures):
            st["engine_capture"] = self.engine_capture_stats()
        caches = self.caches
        if self.config.paged and caches:
            st.update(
                blocks_total=sum(c.blocks_total() for c in caches),
                blocks_free=sum(c.blocks_free() for c in caches),
                blocks_peak=sum(c.blocks_peak for c in caches),
                prefix_hits=sum(c.prefix_hits for c in caches),
                prefix_tokens_saved=sum(c.prefix_tokens_saved
                                        for c in caches),
                cow_forks=sum(c.cow_forks for c in caches))
        return st
