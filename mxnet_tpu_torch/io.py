"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (reference python/mxnet/io.py): the
``DataDesc`` / ``DataBatch`` / ``DataIter`` contracts, ``NDArrayIter``
with pad / discard / roll_over handling of the last batch, ``ResizeIter``,
``PrefetchingIter`` (a thread an iterator) and ``DevicePrefetchIter``.
``NDArrayIter`` holds host (numpy) data and yields NDArrays on the CPU, as
MXNet's does; the module's executor group copies each batch into its
bound arrays, from pageable host memory. ``DevicePrefetchIter`` puts the
batches on the card ahead of the step: staged in pinned host memory and
copied on a stream of its own while the previous step runs, so the step's
own copy is device to device. The file-format iterators ``CSVIter`` and
``MNISTIter`` are in ``io_iters.py``; the record-file image iterators are
not ported.
"""
from __future__ import annotations

import queue
import threading
from collections import namedtuple

import numpy as np
import torch

from . import engine
from . import ndarray as nd
from .context import cpu, resolve_device
from .ndarray import NDArray


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape (and dtype and layout) of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """The iterator contract (reference io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Inputs as a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("NDArrayIter needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("NDArrayIter needs data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays; the last batch is padded from the
    start (``pad``), dropped (``discard``) or carried into the next epoch
    (``roll_over``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.data_list = [v for _, v in self.data] + [v for _, v in
                                                      self.label]
        self.num_source = len(self.data_list)
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" \
                and self.cursor > self.num_data:
            self.cursor = -self.batch_size \
                + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset")
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [nd.array(v[self.cursor:end], ctx=cpu())
                    for _, v in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.array(np.concatenate([v[self.cursor:], v[:pad]], axis=0),
                         ctx=cpu()) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" \
                and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """``data_iter`` resized to ``size`` batches an epoch: it restarts the
    inner iterator when it runs out, and ``reset`` restarts it only with
    ``reset_internal``."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _renamed(descs, renames):
    """The ``DataDesc`` of each iterator, renamed by its dict of
    ``renames`` (None: as they are), in one list."""
    if renames is None:
        return sum(descs, [])
    return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                 if isinstance(x, DataDesc) else DataDesc(*x) for x in d]
                for r, d in zip(renames, descs)], [])


class PrefetchingIter(DataIter):
    """One or more iterators read ahead, each by a thread of its own (the
    reference's PrefetcherIter double buffering): while a batch is used
    the next is read; the batches of the iterators are joined into one
    (data after data, label after label)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True) for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    @property
    def provide_data(self):
        return _renamed([i.provide_data for i in self.iters],
                        self.rename_data)

    @property
    def provide_label(self):
        return _renamed([i.provide_label for i in self.iters],
                        self.rename_label)

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, \
                    "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _host_tensor(x):
    """A batch array (NDArray, tensor or numpy) as a host tensor, read in
    place where it already is one."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


class _Slot:
    """One batch's buffers on the card path: pinned host staging, the
    device copy and (for data under ``cast_dtype``) its cast, the event the
    copy stream records after the copy, and the event the consumer's
    stream records once every step that read the slot has been enqueued
    (the copy stream waits on it before writing the slot again)."""

    def __init__(self):
        self.host, self.dev, self.out = [], [], []
        self.spec = None
        self.copied = None
        self.released = None

    def fit(self, arrays, casts, device):
        """(Re)allocate the buffers where ``arrays`` differ in shape or
        type from what the slot holds."""
        spec = [(tuple(a.shape), a.dtype, c) for a, c in zip(arrays, casts)]
        if spec == self.spec:
            return
        self.spec = spec
        self.host = [torch.empty(s, dtype=t, pin_memory=True)
                     for s, t, _ in spec]
        self.dev = [torch.empty(s, dtype=t, device=device)
                    for s, t, _ in spec]
        self.out = [d if c is None or c == d.dtype else
                    torch.empty(d.shape, dtype=c, device=device)
                    for d, c in zip(self.dev, casts)]


class DevicePrefetchIter(DataIter):
    """Batches of ``base`` placed on the card ahead of their step (the
    reference's pinned-buffer and copy-stream pipelining): ``depth``
    batches (2: double buffering) are fetched by engine ops that hold the
    iterator's variable, so the base iterator is read in push order on
    the engine's worker. On the card each batch is staged in pinned host
    memory and copied with ``non_blocking`` on a copy stream of the
    iterator's own, which records an event; ``next`` makes the caller's
    current stream wait on that event before it hands the batch out.
    ``cast_dtype`` casts the data (not the labels) on the card after the
    copy. ``ctx`` None is the card; ``"cpu"`` places copies on the host.

    A batch's buffers are reused: its pinned and device buffers take the
    batch fetched ``depth + 1`` calls later. ``next`` records an event on
    the caller's stream when it hands out the following batch, after every
    step that read the previous one was enqueued, and the copy stream
    waits on that event before it writes the slot again; the pinned buffer
    is refilled on the host only after its last copy finished. So a batch
    stays valid until the second ``next`` after the one that returned it,
    and no step reads a buffer being rewritten."""

    def __init__(self, base, ctx=None, depth=2, cast_dtype=None):
        super().__init__(getattr(base, "batch_size", 0))
        self._base = base
        self._device = resolve_device(ctx)
        self._on_card = self._device.type == "cuda"
        self._cast = (None if cast_dtype is None
                      else nd._as_torch_dtype(cast_dtype))
        self._depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._gen = 0
        self._iter_var = engine.new_variable()
        self._closed = False
        self._stream = (torch.cuda.Stream(self._device) if self._on_card
                        else None)
        self._slots = [_Slot() for _ in range(self._depth + 1)]
        self._start()

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def _start(self):
        with self._lock:
            self._gen += 1
        self._q = queue.Queue()
        self._done = False
        self._held = None
        self._free = list(range(self._depth + 1))
        for _ in range(self._depth):
            self._push_fetch()

    def _place(self, batch, slot):
        """The batch's arrays on the iterator's device, in ``slot``'s
        buffers on the card."""
        data = [_host_tensor(d) for d in batch.data]
        label = [_host_tensor(x) for x in (batch.label or [])]
        arrays = data + label
        casts = [self._cast] * len(data) + [None] * len(label)
        if not self._on_card:
            outs = [a.to(c) if c is not None else a.clone()
                    for a, c in zip(arrays, casts)]
        else:
            if slot.copied is not None:     # its last copy out of pinned
                slot.copied.synchronize()
            slot.fit(arrays, casts, self._device)
            for h, a in zip(slot.host, arrays):
                h.copy_(a)
            with torch.cuda.stream(self._stream):
                if slot.released is not None:
                    self._stream.wait_event(slot.released)
                for h, d, o in zip(slot.host, slot.dev, slot.out):
                    d.copy_(h, non_blocking=True)
                    if o is not d:
                        o.copy_(d)
                slot.copied = torch.cuda.Event()
                slot.copied.record(self._stream)
            outs = slot.out
        wrap = [NDArray(t) for t in outs]
        return DataBatch(wrap[:len(data)], wrap[len(data):], pad=batch.pad,
                         index=batch.index)

    def _push_fetch(self):
        with self._lock:
            gen = self._gen
        index = self._free.pop(0)
        q = self._q

        def fetch():
            with self._lock:
                if gen != self._gen:       # a retired generation: no-op
                    return
            try:
                batch = self._base.next()
            except StopIteration:
                q.put(None)
                return
            except BaseException as e:     # raised in the consumer
                q.put(e)
                return
            try:
                if self._on_card:
                    with torch.cuda.device(self._device):
                        q.put((index, self._place(batch,
                                                  self._slots[index])))
                else:
                    q.put((index, self._place(batch, self._slots[index])))
            except BaseException as e:
                q.put(e)

        engine.push(fetch, mutable_vars=[self._iter_var],
                    name="prefetch_batch")

    def _release_held(self):
        """The consumer has enqueued every step on the batch it holds:
        mark its slot free once the caller's stream gets past here."""
        if self._held is None:
            return
        slot = self._slots[self._held]
        if self._on_card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._device))
            slot.released = ev
        self._free.append(self._held)
        self._held = None

    def next(self):
        if self._closed:
            raise RuntimeError("DevicePrefetchIter is closed; construct a "
                               "new one")
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is None or isinstance(item, BaseException):
            self._done = True
            if item is None:
                raise StopIteration
            raise item
        index, batch = item
        if self._on_card:
            torch.cuda.current_stream(self._device).wait_event(
                self._slots[index].copied)
        self._release_held()
        self._held = index
        self._push_fetch()
        return batch

    def _retire(self):
        """Invalidate the queued fetches and wait until none runs, so
        nothing reads the base iterator after this."""
        with self._lock:
            self._gen += 1
        engine.wait_for_var(self._iter_var)
        self._release_held()

    def reset(self):
        if self._closed:
            raise RuntimeError("DevicePrefetchIter is closed; construct a "
                               "new one")
        self._retire()
        self._base.reset()
        self._start()

    def close(self):
        """Retire the fetches and the engine variable."""
        if getattr(self, "_closed", True):
            return
        self._retire()
        engine.delete_variable(self._iter_var)
        self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


from .io_iters import CSVIter, MNISTIter  # noqa: E402,F401
