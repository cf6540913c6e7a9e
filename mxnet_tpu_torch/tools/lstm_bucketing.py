"""The bucketed LSTM LM run the card scripts drive.

``chip_smoke.py``'s ``bucketing`` phase trains the LSTM LM the way MXNet's
``example/rnn/lstm_bucketing.py`` does: ``rnn.BucketSentenceIter`` over
``buckets`` (MXNet's own ``[10, 20, 30, 40, 50, 60]``, batch 32, padding
``invalid_label`` 0), ``module.BucketingModule`` with ``sym_gen`` =
``models.get_symbol("lstm-lm", fused=True, seq_len=bucket, dropout=...)``
at the repo's widest LSTM record (vocab 10000, embed = hidden = 512, 2
layers, f32; ``tools/lstm_lm.py``), dropout 0.5 between the layers, SGD
with lr 0.01, wd 1e-5 and momentum 0.9, ``Perplexity(ignore_label=0)``,
and a checkpoint at the epoch's end. The corpus is the JAX package
example's Markov generator (``examples/rnn/lstm_bucketing.py``
``synthetic_sentences``), copied and made from the seed: nothing is
downloaded. The tests run the same functions at a tiny size.
"""
from __future__ import annotations

import random

import numpy as np

BUCKETING = {"vocab": 10000, "embed": 512, "hidden": 512, "layers": 2,
             "dropout": 0.5, "buckets": (10, 20, 30, 40, 50, 60),
             "batch": 32, "invalid_label": 0, "sentences": 960,
             "lr": 0.01, "wd": 1e-5, "momentum": 0.9,
             # card vs CPU at p = 0: 2 batches of 8 in bucket 10, 2 in 60
             "check_batch": 8, "check_keys": (10, 10, 60, 60),
             # the resume: batches of these buckets after the checkpoint
             "resume_keys": (10, 60, 30, 60),
             # dropout in the captured step: Module.fit at this length
             "capture_seq": 35, "capture_batches": 4,
             # the Dropout op's keep-share check
             "mask_elements": 1 << 20}
SEED = 0


def synthetic_sentences(vocab, n, max_len, seed):
    """``n`` sentences of 4 to ``max_len`` ids in [1, vocab): a chain that
    follows ``id * 31 + 7`` 80% of the time, so the LM has something to
    learn (the JAX package's ``examples/rnn/lstm_bucketing.py``)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rng.randint(4, max_len + 1)
        s = [int(rng.randint(1, vocab))]
        for _ in range(length - 1):
            s.append((s[-1] * 31 + 7) % (vocab - 1) + 1
                     if rng.rand() < 0.8 else int(rng.randint(1, vocab)))
        out.append(s)
    return out


def lm_symbol(cfg, seq_len, dropout):
    from .. import models

    return models.get_symbol("lstm-lm", num_classes=cfg["vocab"],
                             seq_len=seq_len, num_embed=cfg["embed"],
                             num_hidden=cfg["hidden"],
                             num_layers=cfg["layers"], dropout=dropout,
                             fused=True)


def sym_gen(cfg, dropout):
    """The ``BucketingModule``'s ``sym_gen``: the fused LSTM LM unrolled
    over the bucket's length."""
    def gen(seq_len):
        return (lm_symbol(cfg, seq_len, dropout), ("data",),
                ("softmax_label",))

    return gen


def bucket_iter(cfg, batch, seed):
    """A ``BucketSentenceIter`` of batch ``batch`` over the seeded corpus;
    Python's ``random`` and numpy's global state are seeded first, as its
    shuffles read them."""
    from ..rnn import BucketSentenceIter

    sentences = synthetic_sentences(cfg["vocab"], cfg["sentences"],
                                    max(cfg["buckets"]), seed)
    random.seed(seed)
    np.random.seed(seed)
    return BucketSentenceIter(sentences, batch, buckets=list(cfg["buckets"]),
                              invalid_label=cfg["invalid_label"])


class BatchList:
    """An iterator over a fixed list of batches (a ``DataIter`` to
    ``fit``), bound at the largest bucket's shapes."""

    def __init__(self, batches, provide_data, provide_label):
        self.batches = list(batches)
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.batch_size = provide_data[0].shape[0]
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos == len(self.batches):
            raise StopIteration
        self._pos += 1
        return self.batches[self._pos - 1]

    next = __next__

    def reset(self):
        self._pos = 0


def pick_batches(it, keys):
    """The batches of one epoch of ``it`` taken in bucket order ``keys``:
    the first unused batch of each key in turn."""
    pool = {}
    it.reset()
    for b in it:
        pool.setdefault(b.bucket_key, []).append(b)
    it.reset()
    out = []
    for k in keys:
        if not pool.get(k):
            raise ValueError("the corpus has too few batches of bucket %d"
                             % k)
        out.append(pool[k].pop(0))
    return BatchList(out, it.provide_data, it.provide_label)


def optimizer_params(cfg):
    return (("learning_rate", cfg["lr"]), ("momentum", cfg["momentum"]),
            ("wd", cfg["wd"]))


def bucketing_module(cfg, device, dropout, batch, seed=SEED):
    """(BucketingModule on ``device`` (None = the card), bound at the
    largest bucket for ``batch``, its parameters Xavier from ``seed``;
    that initializer)."""
    from .. import initializer
    from ..io import DataDesc
    from ..module import BucketingModule

    top = max(cfg["buckets"])
    mod = BucketingModule(sym_gen(cfg, dropout), default_bucket_key=top,
                          context=device)
    mod.bind([DataDesc("data", (batch, top))],
             [DataDesc("softmax_label", (batch, top))])
    init = initializer.Xavier(rng=np.random.RandomState(seed))
    mod.init_params(init)
    return mod, init


def fit_args(cfg, init, num_epoch=1):
    """``fit`` keyword arguments of the run: SGD momentum, ``init``,
    Perplexity ignoring the padding."""
    from .. import metric

    return {"num_epoch": num_epoch, "optimizer": "sgd",
            "optimizer_params": optimizer_params(cfg), "initializer": init,
            "eval_metric": metric.Perplexity(
                ignore_label=cfg["invalid_label"])}


def lstm_steps(cfg, keys):
    """``lstm_step`` launches of a forward over each bucket of ``keys``:
    one per layer and time step."""
    return cfg["layers"] * sum(keys)


def master_module(mod):
    """The default bucket's ``Module`` of a ``BucketingModule``: its
    symbol, the parameters every bucket shares and the optimizer every
    bucket borrows (``callback.module_checkpoint`` saves through it)."""
    return mod._buckets[mod._default_bucket_key]
