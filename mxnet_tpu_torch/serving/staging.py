"""Reusable host staging buffers for zero-copy batch assembly.

Counterpart of ``mxnet_tpu/serving/staging.py``. ``StagingPool`` keeps
ONE long-lived buffer per (bucket, input) and writes request rows
directly into it, so steady-state assembly allocates nothing and touches
only the real rows plus whatever stale tail must be re-zeroed. With
``pinned=True`` (a replica on a card) each buffer is page-locked host
memory (:meth:`StagingPool.tensor` is the torch view of it), so a
bucket's inputs reach the device in one non-blocking copy per input.

The tail's invariant, per bucket: *after every fill, rows >= the filled
count are zero.* A fresh buffer starts all-zero (filled = 0); a fill
writing ``r`` real rows only needs to zero ``[r, prev_filled)``.

Reuse is safe because ``Predictor.forward`` has copied (or, from pinned
memory, finished copying) its inputs to the device before it returns, and
dispatches to one replica are serialized behind its engine variable.

``_lock`` guards only the buffer table (creation / ``retain``); buffer
contents are never touched under it.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


class StagingPool:
    """Per-replica pool of reusable (bucket, input) staging buffers."""

    def __init__(self, example_shapes: Dict[str, tuple],
                 pinned: bool = False):
        self._example_shapes = {n: tuple(s)
                                for n, s in example_shapes.items()}
        self._pinned = bool(pinned)
        self._lock = threading.Lock()
        # (bucket, name) -> buffer; bucket -> rows filled at last dispatch
        self._buffers: Dict[Tuple[int, str], np.ndarray] = {}
        self._tensors: Dict[Tuple[int, str], torch.Tensor] = {}
        self._filled: Dict[int, int] = {}
        self.allocations = 0  # buffers ever created (bench/test probe)

    def _buffer(self, bucket: int, name: str,
                dtype: np.dtype) -> np.ndarray:
        with self._lock:
            buf = self._buffers.get((bucket, name))
            if buf is None or buf.dtype != dtype:
                # fresh all-zero buffer satisfies the filled-watermark
                # invariant at ANY watermark, so _filled is left alone
                # (other inputs of this bucket may have live buffers)
                shape = (bucket,) + self._example_shapes[name]
                t = torch.from_numpy(np.zeros(shape, dtype=dtype))
                if self._pinned:
                    t = t.pin_memory()
                buf = t.numpy()
                self._buffers[(bucket, name)] = buf
                self._tensors[(bucket, name)] = t
                self.allocations += 1
            return buf

    def tensor(self, bucket: int, name: str) -> torch.Tensor:
        """The torch tensor over ``(bucket, name)``'s buffer (pinned when
        the pool is)."""
        with self._lock:
            return self._tensors[(bucket, name)]
    def fill(self, batch, bucket: int,
             input_names: Iterable[str]) -> Dict[str, np.ndarray]:
        """Assemble the padded feed for ``batch`` in the bucket's staging
        buffers and return {name: buffer} (the buffers themselves — the
        caller must be done with them before the next fill for this
        replica, which the replica engine var guarantees)."""
        rows = sum(r.rows for r in batch)
        feed = {}
        for name in input_names:
            dtype = np.result_type(*[r.inputs[name].dtype for r in batch])
            buf = self._buffer(bucket, name, dtype)
            off = 0
            for r in batch:
                arr = r.inputs[name]
                buf[off:off + r.rows] = arr
                off += r.rows
            feed[name] = buf
        prev = self._filled.get(bucket, 0)
        if prev > rows:
            for name in input_names:
                self._buffers[(bucket, name)][rows:prev] = 0
        self._filled[bucket] = rows
        return feed

    def retain(self, buckets: Iterable[int]) -> List[int]:
        """Drop buffers for buckets not in ``buckets`` (called after a
        ladder swap retires programs). Returns the dropped buckets."""
        keep = set(int(b) for b in buckets)
        with self._lock:
            drop = sorted(set(b for b, _ in self._buffers) - keep)
            for b, name in list(self._buffers):
                if b not in keep:
                    del self._buffers[(b, name)]
                    del self._tensors[(b, name)]
            for b in drop:
                self._filled.pop(b, None)
        return drop

    def buffer_count(self) -> int:
        with self._lock:
            return len(self._buffers)
