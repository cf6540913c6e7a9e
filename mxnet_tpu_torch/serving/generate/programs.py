"""The fixed-shape program set for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/generate/programs.py``'s
``DecodePrograms`` and ``PagedDecodePrograms``. The reference compiles
one XLA program per prompt bucket, one decode step and one admit (paged:
the bucket ladder of paged prefills and one paged decode), and caches
them on disk. PyTorch runs eagerly, so here a "program" is the callable
``DecodeModel`` builds; the set keeps the reference's shape discipline
(prompts padded to the bucket ladder, one fixed-shape step over all
slots). There is no program cache and no compile witness.

**Decode capture** (``capture=True``) is the port's counterpart of the
reference's compiled step: on a CUDA device the decode step becomes one
``torch.cuda.CUDAGraph`` over static device buffers for ``lengths``,
``tokens`` and, when paged, ``tables``, replayed every step (the
protocol of ``executor.py``'s ``_TrainStep``: warm-up calls on a side
stream, one capture, then replays). On the CPU the step runs eagerly.

**Replicas** (the scheduler's ``replicas``): :meth:`DecodePrograms.replica`
makes the program set of one more replica, which shares the models, the
shapes and the prefill programs and has a decode step (and verify) of its
own, so its own CUDA graph when captured.

**Speculative decoding** (``spec.py``): ``step_model`` is the draft,
whose forward is the decode step, and ``enable_verify(W)`` adds the
TARGET model's verify over a (slots, W) window, a step of its own
(captured as its own graph, keyed on the slabs as the decode step's).

The reference donates the slabs to the step and admit programs and
adopts the slabs they return; here those callables update the slabs in
place and return none, so the steady-state step allocates only its
logits, and a captured graph keeps working on the slabs it was captured
on.

The reference's decode passes ``jnp.asarray`` views of the caller's host
arrays to a step that runs asynchronously, so a caller that edits them
after the call races the step (``ROADMAP.md`` §3). Every decode here has
copied its host arrays to the device (a synchronous copy from pageable
memory) before it returns.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...context import prepare_capture_thread
from ...ops.kernels import _launches
from ..batcher import ServingError
from .model import KV_SLAB_DTYPES, DecodeModel

#: eager steps on a side stream before the decode step is captured (lazy
#: initialization, cuBLAS workspaces happen outside the capture), as the
#: executor's ``CAPTURE_WARMUP``
CAPTURE_WARMUP = 2


def _check_kv_dtype(kv_dtype: str):
    if kv_dtype not in KV_SLAB_DTYPES:
        raise ServingError("decode: unknown kv_dtype %r (have %s)"
                           % (kv_dtype, sorted(KV_SLAB_DTYPES)))


def _bind(model: DecodeModel, fn: Callable) -> Callable:
    """``fn`` with ``model``'s params as its first argument."""
    params = model.params
    return lambda *args: fn(params, *args)


def _check_buckets(prefill_buckets, capacity) -> List[int]:
    buckets = sorted({int(b) for b in prefill_buckets})
    if not buckets:
        raise ServingError("decode: empty prefill bucket ladder")
    if buckets[-1] > capacity:
        raise ServingError("decode: prefill bucket %d exceeds kv capacity %d"
                           % (buckets[-1], capacity))
    return buckets


class _DecodeStep:
    """The decode step, eager or as one CUDA graph.

    ``fn(*slabs, *ints)`` is the model's step over the slab tensors and
    the (slots,) / (slots, MB) int64 device tensors made from the host
    arrays of each call. Captured (``capture`` on a CUDA device): the
    host arrays are copied into static device buffers, the first
    ``CAPTURE_WARMUP`` calls at a set of slabs run eagerly on a side
    stream, the next one captures the step and replays it, and every
    later call replays. A capture is keyed on the slabs' addresses,
    shapes and types: other slabs (``KVCacheManager.reset``) drop the
    graph and capture again. A capture that fails raises; the step never
    quietly runs eagerly instead."""

    def __init__(self, fn: Callable, device: torch.device, capture: bool,
                 name: str = "decode step"):
        self._fn = fn
        self._name = name
        self._device = device
        self.captured = bool(capture) and device.type == "cuda"
        self.warmup_calls = 0
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0
        self.drop()

    def drop(self):
        """Forget the graph, its static buffers and the slabs it holds."""
        self._key = None
        self._slabs = None        # the slabs the graph reads and writes
        self._inputs = None       # static int64 device buffers
        self._graph = None
        self._out = None
        self._delta = None
        self._calls = 0

    def stats(self) -> Dict[str, object]:
        return {"path": "captured" if self.captured else "eager",
                "warmup_calls": self.warmup_calls,
                "captures": self.captures, "replays": self.replays,
                "eager_calls": self.eager_calls}

    def __call__(self, slabs: Sequence[torch.Tensor],
                 ints: Sequence[np.ndarray]) -> torch.Tensor:
        ints = [np.ascontiguousarray(a, np.int64) for a in ints]
        if not self.captured:
            # torch.tensor copies: the step never aliases the caller's
            # arrays, on the CPU either
            out = self._fn(*slabs, *[torch.tensor(a, device=self._device)
                                     for a in ints])
            self.eager_calls += 1
            return out
        key = (tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                     for t in slabs), tuple(a.shape for a in ints))
        if key != self._key:
            self.drop()
            self._key = key
            self._slabs = tuple(slabs)
            self._inputs = [torch.empty(a.shape, dtype=torch.int64,
                                        device=self._device) for a in ints]
        for buf, a in zip(self._inputs, ints):
            # a blocking copy from pageable memory: the caller's arrays
            # have been read when it returns. A pinned staging buffer with
            # non_blocking=True, reused across steps, would bring back the
            # reference's race (the next step's edit could land first).
            buf.copy_(torch.from_numpy(a))
        if self._calls < CAPTURE_WARMUP:
            out = self._warmup()
        else:
            if self._graph is None:
                self._capture()
            # a capture runs no kernel, so the step that captures replays
            # to produce its result. The step writes each row's k/v at the
            # same positions from the same inputs, so running it again
            # (were a replay ever repeated) would write the same values
            self._graph.replay()
            _launches.replayed(self._delta)
            self.replays += 1
            out = self._out.clone()
        self._calls += 1
        return out

    def _warmup(self):
        main = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._fn(*self._slabs, *self._inputs)
        main.wait_stream(side)
        out.record_stream(main)
        self.warmup_calls += 1
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        # the engine worker that captures may not be the one that warmed up
        stream = torch.cuda.Stream(self._device)
        stream.wait_stream(torch.cuda.current_stream(self._device))
        prepare_capture_thread(self._device, stream)

        def record():
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._out = self._fn(*self._slabs, *self._inputs)

        try:
            self._delta = _launches.capture(record)
        except Exception as e:
            self.drop()
            raise ServingError("the %s could not be captured as a "
                               "CUDA graph: %s" % (self._name, e),
                               code="dispatch_error") from e
        self._graph = graph
        self.captures += 1


class DecodePrograms:
    """The program set for one model at one slot/capacity config.

    Construction and ``ensure_prefill``'s lazy per-bucket build happen on
    the scheduler thread; the callables run on the engine worker.
    """

    def __init__(self, model: DecodeModel, slots: int, capacity: int,
                 prefill_buckets: Sequence[int],
                 kv_dtype: str = "float32", capture: bool = False,
                 step_model: Optional[DecodeModel] = None):
        buckets = _check_buckets(prefill_buckets, capacity)
        _check_kv_dtype(kv_dtype)
        self.model = model
        # the model the decode step runs: ``model``, or under speculative
        # decoding the draft (the verify is the target's step)
        self.step_model = step_model or model
        self.device = model.device
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.buckets: List[int] = buckets
        self.kv_dtype = kv_dtype
        self.capture = bool(capture)
        self._prefill: Dict[int, Callable] = {}
        self._admit = model.build_admit(self.slots, self.capacity, kv_dtype)
        self._step = self._make_step()
        self._verify: Optional[_DecodeStep] = None
        self.spec_window = 0

    def _make_step(self) -> "_DecodeStep":
        return _DecodeStep(
            _bind(self.step_model, self.step_model.build_decode(
                self.slots, self.capacity, self.kv_dtype)),
            self.device, self.capture)

    def replica(self) -> "DecodePrograms":
        """The program set of one more replica: the same models, shapes and
        prefill programs (one dict, built on the scheduler thread), its
        own decode step and verify, so its own graphs when captured."""
        other = copy.copy(self)
        other._step = self._make_step()
        other._verify = None
        if self.spec_window:
            other.spec_window = 0
            other.enable_verify(self.spec_window)
        return other

    # --- shapes -----------------------------------------------------------
    def _slab_shapes(self):
        """(value slab shape, scale slab shape)."""
        return (self.model.kv_slab_shape(self.slots, self.capacity),
                self.model.kv_scale_slab_shape(self.slots, self.capacity))

    def fresh_slabs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = self._slab_shapes()[0]
        elem = KV_SLAB_DTYPES[self.kv_dtype]
        return (torch.zeros(shape, dtype=elem, device=self.device),
                torch.zeros(shape, dtype=elem, device=self.device))

    def fresh_scale_slabs(self) -> Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        """f32 per-position scale slabs (int8 KV only, else None)."""
        if self.kv_dtype != "int8":
            return None
        shape = self._slab_shapes()[1]
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    def kv_bytes(self) -> int:
        """Bytes in the K+V slabs, int8's scale slabs included."""
        shape, sshape = self._slab_shapes()
        elem = KV_SLAB_DTYPES[self.kv_dtype].itemsize
        total = 2 * int(np.prod(shape)) * elem
        if self.kv_dtype == "int8":
            total += 2 * int(np.prod(sshape)) * 4
        return total

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Smallest ladder bucket holding the prompt, or None (too long)."""
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return None

    def ensure_prefill(self, prompt_len: int):
        """Build (or no-op) the bucket program for ``prompt_len`` on the
        calling thread, so engine workers only run built programs."""
        bucket = self.bucket_for(prompt_len)
        if bucket is not None:
            self._prefill_for(bucket)

    def _prefill_for(self, bucket: int) -> Callable:
        prog = self._prefill.get(bucket)
        if prog is None:
            prog = self._build_prefill(bucket)
            self._prefill[bucket] = prog
        return prog

    def _build_prefill(self, bucket: int) -> Callable:
        return self.model.build_prefill(bucket, self.capacity, self.kv_dtype)

    def _padded(self, token_ids: Sequence[int], what: str):
        """(bucket, (1, bucket) int64 device tokens, (1,) length)."""
        n = len(token_ids)
        bucket = self.bucket_for(n)
        if bucket is None:
            raise ServingError(
                "%s length %d exceeds largest prefill bucket %d"
                % (what, n, self.buckets[-1]), code="too_large")
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = np.asarray(token_ids, np.int64)
        return (bucket, torch.from_numpy(toks).to(self.device),
                torch.tensor([n], dtype=torch.int64, device=self.device))

    # --- the decode step's capture ------------------------------------------
    def capture_stats(self) -> Dict[str, object]:
        """Which path the decode step takes (``captured`` / ``eager``) and
        its warm-up calls, captures, replays and eager calls; with the
        verify enabled, the verify's under ``"verify"``."""
        st = self._step.stats()
        if self._verify is not None:
            st["verify"] = self._verify.stats()
        return st

    def drop_capture(self):
        """Drop the captured decode and verify graphs (new slabs: capture
        again)."""
        self._step.drop()
        if self._verify is not None:
            self._verify.drop()

    # --- speculative decoding (spec.py) ------------------------------------
    def enable_verify(self, window: int):
        """Build the verify of the TARGET model over a (slots, W) window
        (W = spec_tokens + 1), captured like the decode step (its own
        graph at fixed shapes). Idempotent a window."""
        W = int(window)
        if self._verify is not None and self.spec_window == W:
            return
        self._verify = _DecodeStep(
            _bind(self.model, self._build_verify(W)), self.device,
            self.capture, name="verify")
        self.spec_window = W

    def _build_verify(self, window: int) -> Callable:
        return self.model.build_verify(self.slots, self.capacity, window,
                                       self.kv_dtype)

    def _verify_step(self) -> "_DecodeStep":
        if self._verify is None:
            raise ServingError("decode: verify called before enable_verify")
        return self._verify

    def verify(self, k_slab, v_slab, lengths, wtokens, ks_slab=None,
               vs_slab=None):
        """Score a (slots, W) draft window with the target model: writes
        the window's k/v over the draft's in place and returns the logits
        (slots, W, V). The host arrays have been read when it returns."""
        return self._verify_step()(
            self._slabs(k_slab, v_slab, ks_slab, vs_slab), (lengths, wtokens))

    # --- execution --------------------------------------------------------
    def prefill(self, token_ids: Sequence[int]):
        """Run one prompt through its bucket's prefill program.
        Returns (last_logits (V,), k_new, v_new (L, 1, Hkv, C, Dh)); int8
        KV appends the (L, 1, C) ks_new, vs_new scale rows."""
        bucket, toks, n = self._padded(token_ids, "prompt")
        out = self._prefill_for(bucket)(self.model.params, toks, n)
        return (out[0][0],) + tuple(out[1:])

    def decode(self, k_slab, v_slab, lengths, tokens, ks_slab=None,
               vs_slab=None):
        """One step for every slot. ``lengths``/``tokens``: (slots,) ints
        (inactive slots: length 0, token 0). Updates the slabs (int8: and
        the scale slabs) in place and returns the logits (slots, V). The
        host arrays have been read when it returns."""
        return self._step(self._slabs(k_slab, v_slab, ks_slab, vs_slab),
                          (lengths, tokens))

    def _slabs(self, k_slab, v_slab, ks_slab, vs_slab):
        if self.kv_dtype == "int8":
            if ks_slab is None or vs_slab is None:
                raise ServingError("decode: int8 KV needs its scale slabs")
            return (k_slab, v_slab, ks_slab, vs_slab)
        return (k_slab, v_slab)

    def admit(self, k_slab, v_slab, k_new, v_new, slot: int, ks_slab=None,
              vs_slab=None, ks_new=None, vs_new=None):
        """Slot a prefilled sequence's K/V (int8: and its scale rows) into
        the slabs, in place."""
        if self.kv_dtype == "int8":
            self._admit(k_slab, v_slab, ks_slab, vs_slab, k_new, v_new,
                        ks_new, vs_new, slot)
        else:
            self._admit(k_slab, v_slab, k_new, v_new, slot)


class PagedDecodePrograms(DecodePrograms):
    """Program set for block/paged KV decode (``paged=True``).

    Two kinds, as in the reference: the bucket ladder of **paged
    prefills** (CoW fork + attention over the cached prefix gathered
    through the block table + the suffix's scatter into its blocks, one
    callable per bucket; there is no separate admit) and one **paged
    decode** step (each row's new k/v into its private block, per-row
    dense views gathered through the tables, masked by length). The slabs
    hold ``num_blocks + 1`` blocks: block 0 is the trash block.
    """

    def __init__(self, model: DecodeModel, slots: int, capacity: int,
                 prefill_buckets: Sequence[int], block_tokens: int,
                 num_blocks: int, kv_dtype: str = "float32",
                 capture: bool = False,
                 step_model: Optional[DecodeModel] = None):
        buckets = _check_buckets(prefill_buckets, capacity)
        if block_tokens < 1:
            raise ServingError("decode: block_tokens must be >= 1")
        if num_blocks < 1:
            raise ServingError("decode: need at least one usable KV block")
        _check_kv_dtype(kv_dtype)
        self.model = model
        self.step_model = step_model or model    # the draft under spec
        self.device = model.device
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.buckets: List[int] = buckets
        self.kv_dtype = kv_dtype
        self.capture = bool(capture)
        self.block_tokens = int(block_tokens)
        # MB = a sequence's table width: every position < capacity is
        # addressable through a table
        self.max_blocks = -(-self.capacity // self.block_tokens)
        self.num_blocks = int(num_blocks)        # usable (excludes trash)
        self._prefill: Dict[int, Callable] = {}
        self._step = self._make_step()
        self._verify: Optional[_DecodeStep] = None
        self.spec_window = 0

    def _make_step(self) -> "_DecodeStep":
        return _DecodeStep(
            _bind(self.step_model, self.step_model.build_paged_decode(
                self.slots, self.block_tokens, self.max_blocks,
                self.kv_dtype)),
            self.device, self.capture)

    # --- shapes -----------------------------------------------------------
    def _slab_shapes(self):
        nb = self.num_blocks + 1
        return (self.model.paged_slab_shape(nb, self.block_tokens),
                self.model.paged_scale_slab_shape(nb, self.block_tokens))

    def _build_prefill(self, bucket: int) -> Callable:
        return self.model.build_paged_prefill(bucket, self.block_tokens,
                                              self.max_blocks, self.kv_dtype)

    def _build_verify(self, window: int) -> Callable:
        return self.model.build_paged_verify(
            self.slots, self.block_tokens, self.max_blocks, window,
            self.kv_dtype)

    # --- execution --------------------------------------------------------
    def paged_prefill(self, k_slab, v_slab, table, ctx_len: int,
                      suffix: Sequence[int], fork_src: int, fork_dst: int,
                      ks_slab=None, vs_slab=None):
        """Prefill ``suffix`` against the ``ctx_len``-token cached prefix
        reachable through ``table`` (after copying block ``fork_src`` into
        ``fork_dst``), scattering the suffix k/v into its blocks in place.
        Returns the last position's logits (V,)."""
        bucket, toks, n = self._padded(suffix, "suffix")

        def scalar(v):
            return torch.tensor(int(v), dtype=torch.int64,
                                device=self.device)

        table = torch.tensor(np.asarray(table, np.int64), device=self.device)
        args = (table, scalar(ctx_len), toks, n, scalar(fork_src),
                scalar(fork_dst))
        last = self._prefill_for(bucket)(
            self.model.params,
            *self._slabs(k_slab, v_slab, ks_slab, vs_slab), *args)
        return last[0]

    def prefill(self, token_ids: Sequence[int]):
        raise ServingError("paged decode has no standalone prefill — "
                           "use paged_prefill (admit is folded in)")

    def admit(self, *a, **kw):
        raise ServingError("paged decode has no standalone admit — "
                           "the paged prefill scatters in place")

    def decode(self, k_slab, v_slab, tables, lengths, tokens, ks_slab=None,
               vs_slab=None):
        """One step for every slot, indexed through the block tables
        (slots, MB). Updates the slabs in place and returns the logits;
        the host arrays have been read when it returns."""
        return self._step(self._slabs(k_slab, v_slab, ks_slab, vs_slab),
                          (tables, lengths, tokens))

    def verify(self, k_slab, v_slab, tables, lengths, wtokens, ks_slab=None,
               vs_slab=None):
        """The target model's verify of a (slots, W) window through the
        block tables: as ``DecodePrograms.verify``."""
        return self._verify_step()(
            self._slabs(k_slab, v_slab, ks_slab, vs_slab),
            (tables, lengths, wtokens))
