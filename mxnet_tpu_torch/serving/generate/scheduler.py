"""Orca-style iteration-level scheduler for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/generate/scheduler.py`` (unpaged path).
One scheduler thread drives one KV cache: each loop iteration it
(1) expires/admits waiting prompts into freed slots — each admission is a
prefill through the flash-attention kernel plus an admit into the slot
row — (2) pushes ONE fixed-shape decode step over all slots onto the
engine (``mutable_vars=[kv var]``, so the engine orders step N+1 after
step N and after any admits between them), (3) fences, samples on the
host, streams tokens out, and retires finished sequences. The batch is
re-formed every step as sequences finish and new ones join mid-flight.

The scheduler's ``_cond`` is never held across an engine push or fence;
``TokenStream._cond`` and ``KVCacheManager._lock`` are leaves taken
under it.

Not ported yet: paged KV, speculative decoding, weight quantization, int8
KV and engine capture — setting any of them raises ``ServingError``
(code ``not_ported``). Telemetry spans, the flight recorder and the
reference's ``replicas`` (one cache per replica, for the multi-device
``InferenceServer``) are not ported either.
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
from ..batcher import ServingError
from .kv_cache import KVCacheManager
from .model import DecodeModel
from .programs import DecodePrograms
from .spec import sample_token
from .stream import TokenStream

_KV_ALIASES = {"f32": "float32", "fp32": "float32", "float32": "float32",
               "bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8"}


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


def normalize_kv_dtype(name: str) -> str:
    """Canonicalize an ``MXNET_DECODE_KV_DTYPE`` spelling (f32|bf16|int8,
    long forms accepted)."""
    try:
        return _KV_ALIASES[str(name).strip().lower()]
    except KeyError:
        raise ServingError("MXNET_DECODE_KV_DTYPE must be one of %s, got %r"
                           % (sorted(set(_KV_ALIASES)), name))


@dataclasses.dataclass
class GenerateConfig:
    """Decode-side knobs; every default reads its ``MXNET_DECODE_*`` env
    var at construction time, with the reference's names and defaults.
    Head counts are architecture facts of the checkpoint. The knobs of
    unported features (paged, spec, quant_weights, capture, int8 KV) are
    kept so that setting one raises instead of being ignored; their
    sub-knobs (block sizes, draft choice) come with them."""
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
    kv_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_DECODE_KV_DTYPE", "f32"))
    quant_weights: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_QUANT_WEIGHT_DTYPE", ""))
    spec: bool = dataclasses.field(
        default_factory=lambda: _env_flag("MXNET_DECODE_SPEC", "0"))


def _refuse_unported(config: GenerateConfig, kv_dtype: str):
    for knob, on in (("paged", config.paged), ("spec", config.spec),
                     ("quant_weights", bool(config.quant_weights)),
                     ("capture", config.capture),
                     ("kv_dtype='int8'", kv_dtype == "int8")):
        if on:
            raise ServingError("decode: %s is not yet ported" % knob,
                               code="not_ported")


class _Active:
    """One sequence occupying a slot, with its sampling context
    (temperature 0 = greedy; a private RandomState per stream keeps draws
    deterministic per seed and independent of co-resident streams)."""
    __slots__ = ("stream", "slot", "last_token", "generated",
                 "temperature", "rng")

    def __init__(self, stream, slot, last_token, generated,
                 temperature=0.0, rng=None):
        self.stream = stream
        self.slot = slot
        self.last_token = last_token
        self.generated = generated
        self.temperature = temperature
        self.rng = rng


class DecodeScheduler:
    """Continuous-batching decode over one model and one pair of KV slabs
    on the model's device."""

    def __init__(self, model: DecodeModel, config: GenerateConfig):
        self.config = config
        self.kv_dtype = normalize_kv_dtype(config.kv_dtype)
        _refuse_unported(config, self.kv_dtype)
        self.model = model
        self.programs = DecodePrograms(model, config.slots,
                                       config.max_context,
                                       config.prefill_buckets,
                                       kv_dtype=self.kv_dtype)
        self.cache: Optional[KVCacheManager] = None
        self._cond = threading.Condition()
        self._queue: deque = deque()   # (stream, prompt, temperature, rng)
        self._active: Dict[int, _Active] = {}     # slot -> sequence
        self._state = "stopped"        # running|draining|stopped
        self._thread: Optional[threading.Thread] = None
        self.steps = 0

    # --- lifecycle --------------------------------------------------------
    def start(self):
        with self._cond:
            if self._state != "stopped":
                return
            self._state = "running"
        self.cache = KVCacheManager(self.programs)
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
            self.cache.free(a.slot)
            leftovers.append(a.stream)
        for s in leftovers:
            s._fail(ServingError("decode scheduler stopped", code=code))
        if self.cache is not None:
            _engine.fence([self.cache.var]).wait()
            _engine.delete_variable(self.cache.var)
        self.cache = None

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
        ``seed``. ``request_id`` rides on the TokenStream."""
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
                             request_id=request_id, trace=trace)
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
        for s in expired:
            s._fail(ServingError("expired before a decode slot freed",
                                 code="deadline_exceeded"))
        # active sequences: retire cancelled/expired before the next step
        for a in list(self._active.values()):
            if a.stream.cancelled:
                self._retire(a, reason="cancelled")
            elif a.stream.deadline is not None and now > a.stream.deadline:
                self._retire(a, error=ServingError(
                    "deadline exceeded mid-stream",
                    code="deadline_exceeded"))

    def _retire(self, a: _Active, reason: Optional[str] = None,
                error: Optional[ServingError] = None):
        self.cache.free(a.slot)
        with self._cond:
            self._active.pop(a.slot, None)
        if error is not None:
            a.stream._fail(error)
        else:
            a.stream._finish(reason or "eos")

    def _admit_waiting(self):
        """Prefill waiting prompts into free slots. Each admission is one
        engine op on the kv var (prefill -> slot insert), fenced as a
        group so fresh sequences join the very next step."""
        admitted = []         # (active, holder)
        cache = self.cache
        while True:
            with self._cond:
                if not self._queue:
                    break
                stream, prompt, temp, rng = self._queue.popleft()
            plan = cache.try_admit(stream, prompt, stream.max_new_tokens)
            if plan is None:      # slots exhausted — wait for retirement,
                with self._cond:  # never evict mid-stream
                    self._queue.appendleft((stream, prompt, temp, rng))
                break
            # build the bucket's prefill program here (scheduler thread)
            # so the engine op never mutates the program dict
            self.programs.ensure_prefill(len(plan.suffix))
            holder: Dict[str, object] = {}
            admitted.append((_Active(stream, plan.slot, 0, 0,
                                     temperature=temp, rng=rng), holder))

            def op(plan=plan, holder=holder):
                try:
                    last, k_new, v_new = self.programs.prefill(plan.suffix)
                    self.programs.admit(cache.k_slab, cache.v_slab, k_new,
                                        v_new, plan.slot)
                    holder["logits"] = last.float().cpu().numpy()
                except Exception as e:      # noqa: BLE001 — reported below
                    holder["error"] = e

            _engine.push(op, mutable_vars=[cache.var], name="decode.prefill")
        if not admitted:
            return
        _engine.fence([cache.var]).wait()
        for a, holder in admitted:
            err = holder.get("error")
            if err is not None:
                cache.free(a.slot)
                a.stream._fail(ServingError(
                    "prefill failed: %s" % err, code="dispatch_error"))
                continue
            with self._cond:
                self._active[a.slot] = a
            self._emit(a, sample_token(holder["logits"], a.temperature,
                                       a.rng))

    def _emit(self, a: _Active, token: int) -> bool:
        """Deliver one sampled token; retire the sequence if done and
        return False once it has retired."""
        a.last_token = token
        a.generated += 1
        a.stream._emit(token)
        eos = self.config.eos_id
        if eos is not None and token == eos:
            self._retire(a, reason="eos")
            return False
        if a.generated >= a.stream.max_new_tokens:
            self._retire(a, reason="max_tokens")
            return False
        if self.cache.length(a.slot) >= self.programs.capacity:
            # the next step would write at kv position == capacity (the
            # write position IS the current length)
            self._retire(a, reason="capacity")
            return False
        return True

    def _step_all(self):
        """One decode step over all slots when any is occupied: push the
        step op, fence, then sample/stream on the host."""
        cache = self.cache
        with self._cond:
            actives = list(self._active.values())
        if not actives:
            return
        lengths = np.zeros(cache.slots, np.int64)
        tokens = np.zeros(cache.slots, np.int64)
        for a in actives:
            lengths[a.slot] = cache.length(a.slot)
            tokens[a.slot] = a.last_token
        holder: Dict[str, object] = {}

        def op():
            try:
                logits = self.programs.decode(cache.k_slab, cache.v_slab,
                                              lengths, tokens)
                holder["logits"] = logits.float().cpu().numpy()
            except Exception as e:      # noqa: BLE001 — reported below
                holder["error"] = e

        _engine.push(op, mutable_vars=[cache.var], name="decode.step")
        _engine.fence([cache.var]).wait()
        self.steps += 1
        err = holder.get("error")
        if err is not None:
            # a failed in-place step may leave the slabs half written:
            # rebuild the cache rather than step on that state
            for a in actives:
                self._retire(a, error=ServingError(
                    "decode step failed: %s" % err, code="dispatch_error"))
            cache.reset()
            return
        logits = holder["logits"]
        for a in actives:
            cache.advance(a.slot)
            self._emit(a, sample_token(logits[a.slot], a.temperature, a.rng))

    # --- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._cond:
            queued = len(self._queue)
            active = len(self._active)
        return {"steps": self.steps, "queued": queued, "active": active,
                "kv_dtype": self.kv_dtype}
