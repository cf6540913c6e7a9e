"""File-format data iterators: ``CSVIter`` and ``MNISTIter``.

Counterpart of part of ``mxnet_tpu/io_iters.py`` (reference
src/io/iter_csv.cc, iter_mnist.cc): host-side numpy readers feeding the
``DataBatch`` protocol with NDArrays on the CPU, as ``NDArrayIter`` does.
The record-file image iterators (``ImageRecordIter``,
``ImageRecordUInt8Iter``, ``ImageDetRecordIter``) decode JPEG through an
image codec and are not ported.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from . import ndarray as nd
from .context import cpu
from .io import DataBatch, DataDesc, DataIter


class CSVIter(DataIter):
    """Rows of ``data_csv`` (and ``label_csv``, else zeros) reshaped to
    ``data_shape`` / ``label_shape``; with ``round_batch`` the last batch
    wraps to the start and reports its pad, else it is short."""

    def __init__(self, data_csv, data_shape, batch_size, label_csv=None,
                 label_shape=(1,), round_batch=True, **kwargs):
        super().__init__(batch_size)
        self._data = np.loadtxt(data_csv, delimiter=",", ndmin=2,
                                dtype=np.float32).reshape(
                                    (-1,) + tuple(data_shape))
        if label_csv is not None:
            self._label = np.loadtxt(label_csv, delimiter=",", ndmin=2,
                                     dtype=np.float32).reshape(
                                         (-1,) + tuple(label_shape))
        else:
            self._label = np.zeros((len(self._data),) + tuple(label_shape),
                                   np.float32)
        self._round_batch = round_batch
        self._cursor = 0
        self._provide_data = [DataDesc("data",
                                       (batch_size,) + tuple(data_shape))]
        self._provide_label = [DataDesc("softmax_label",
                                        (batch_size,) + tuple(label_shape))]

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._data):
            raise StopIteration
        end = self._cursor + self.batch_size
        d = self._data[self._cursor:end]
        lab = self._label[self._cursor:end]
        pad = 0
        if len(d) < self.batch_size and self._round_batch:
            pad = self.batch_size - len(d)
            d = np.concatenate([d, self._data[:pad]])
            lab = np.concatenate([lab, self._label[:pad]])
        self._cursor = end
        if lab.ndim == 2 and lab.shape[1] == 1:
            lab = lab[:, 0]
        return DataBatch([nd.array(d, ctx=cpu())], [nd.array(lab, ctx=cpu())],
                         pad=pad)


class MNISTIter(DataIter):
    """MNIST idx files (gzipped or not): images (N, 1, 28, 28) scaled to
    [0, 1] (``flat``: (N, 784)), labels as f32; ``shuffle`` draws the
    order from ``seed`` at each reset; ``num_parts`` / ``part_index``
    shard by stride; the last batch wraps to the start and reports its
    pad."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        self._images = self._read_idx(image)
        self._labels = self._read_idx(label)
        if num_parts > 1:
            self._images = self._images[part_index::num_parts]
            self._labels = self._labels[part_index::num_parts]
        if flat:
            self._images = self._images.reshape(len(self._images), -1)
        else:
            self._images = self._images[:, None]
        self._images = self._images.astype(np.float32) / 255.0
        self._labels = self._labels.astype(np.float32)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(len(self._images))
        self._cursor = 0
        self.reset()
        self._provide_data = [DataDesc("data", (batch_size,)
                                       + self._images.shape[1:])]
        self._provide_label = [DataDesc("softmax_label", (batch_size,))]

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rb") as f:
            ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), np.uint8).reshape(dims)

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._rng.shuffle(self._order)

    def next(self):
        if self._cursor >= len(self._images):
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        pad = 0
        if len(idx) < self.batch_size:
            pad = self.batch_size - len(idx)
            idx = np.concatenate([idx, self._order[:pad]])
        self._cursor += self.batch_size
        return DataBatch([nd.array(self._images[idx], ctx=cpu())],
                         [nd.array(self._labels[idx], ctx=cpu())], pad=pad)
