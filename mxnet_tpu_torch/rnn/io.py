"""RNN data iterators.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference python/mxnet/rnn/io.py):
``encode_sentences`` and ``BucketSentenceIter``. The iterator makes the
same Python ``random.shuffle`` and numpy calls in the same order as the
JAX package's, so equal seeds give equal batches; it holds its arrays on
the host, as ``io.NDArrayIter`` does, and the module moves each batch to
its device.
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """(sentences as lists of ids, vocab): each new word takes the next
    id from ``start_label``, skipping ``invalid_label``; with a given
    ``vocab`` an unknown word raises."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    raise MXNetError("Unknown token %s" % word)
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Sentences grouped into length buckets, each batch padded with
    ``invalid_label`` to its bucket's length and tagged with ``bucket_key``
    for ``BucketingModule``; the label is the sentence shifted left by one
    (or, with ``sequence_labels``, one label a sentence). ``buckets`` None
    takes every length with at least a batch of sentences."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", sequence_labels=None):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount(
                [len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        self._seq_labels = ([[] for _ in buckets]
                            if sequence_labels is not None else None)
        for si, sent in enumerate(sentences):
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
            if self._seq_labels is not None:
                self._seq_labels[buck].append(sequence_labels[si])
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if self._seq_labels is not None:
            self._seq_labels = [np.asarray(i, dtype=dtype)
                                for i in self._seq_labels]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket." % ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = 0
        self.default_bucket_key = max(buckets)

        self.provide_data = [DataDesc(data_name,
                                      (batch_size, self.default_bucket_key))]
        self.provide_label = [DataDesc(
            label_name, (batch_size,) if self._seq_labels is not None
            else (batch_size, self.default_bucket_key))]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in range(
                0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        if self._seq_labels is None:
            for buck in self.data:
                np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for bi, buck in enumerate(self.data):
            if self._seq_labels is not None:
                # data and per-sentence labels under one permutation
                perm = np.random.permutation(len(buck)) if len(buck) else []
                buck = buck[perm]
                self.data[bi] = buck
                self._seq_labels[bi] = self._seq_labels[bi][perm]
                label = self._seq_labels[bi]
            else:
                label = np.empty_like(buck)
                label[:, :-1] = buck[:, 1:]
                label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)])
