"""The LSTM language-model training run the card scripts drive.

``chip_smoke.py`` (its ``lstm`` phase), :mod:`mxnet_tpu_torch.tools.
profile_lstm` and :mod:`mxnet_tpu_torch.tools.lstm_spread` train the
repo's widest LSTM record, "PTB-class LM training, H=512, bs 128"
(``docs/perf.md``, built by ``examples/rnn/bench_lstm.py`` ``ptb_lm``;
BASELINE config 3): ``models.get_symbol("lstm-lm", num_classes=10000,
seq_len=35, num_embed=512, num_hidden=512, num_layers=2, fused=True)``,
f32, dropout 0, ``Xavier()`` from the seed, SGD lr 0.5 without momentum,
through ``Module.fit`` over an ``NDArrayIter`` of seeded token ids
(``randint(0, vocab)`` as f32, data then labels, as ``bench_lstm.py``
draws them) with a Perplexity metric, at batch 128 over ``batches``
batches. The card-vs-CPU check runs the same model at ``check_batch`` for
``check_steps`` batches. All take the configuration and the set-up from
here.
"""
from __future__ import annotations

import numpy as np

LSTM_LM = {"vocab": 10000, "embed": 512, "hidden": 512, "layers": 2,
           "seq": 35, "batch": 128, "batches": 8, "lr": 0.5,
           "check_batch": 8, "check_steps": 2}
SEED = 0
#: the (N, H) the scan's steps run at (the run's batch 128 and the check's
#: 8): in the scan's layout they must take the f32 tile body (16-byte
#: copies) and, in bf16, the wgmma body
STEP_SHAPES = ((LSTM_LM["batch"], LSTM_LM["hidden"]),
               (LSTM_LM["check_batch"], LSTM_LM["hidden"]))
#: lstm_step, kernel vs plain (atol, rtol). f32: an H-long dot product (H
#: up to 512, |gates| of order 1) summed in another order than the plain
#: version's GEMM differs in the last f32 bits, and sigmoid / tanh have
#: slope <= 1. bf16: both round the same f32 maths to bf16, so a value whose
#: f32 forms straddle a rounding point differs by one bf16 ulp, at most
#: 2^-7 = 7.8e-3 of |x| (rtol 1e-2 leaves a margin)
STEP_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 1e-2)}


def lstm_symbol(cfg):
    from .. import models

    return models.get_symbol("lstm-lm", num_classes=cfg["vocab"],
                             seq_len=cfg["seq"], num_embed=cfg["embed"],
                             num_hidden=cfg["hidden"],
                             num_layers=cfg["layers"], fused=True)


def lstm_data(cfg, batch, batches, seed):
    """Seeded host ids: ``batch * batches`` sequences of data, then as many
    of labels, each ``randint(0, vocab)`` as f32."""
    rng = np.random.RandomState(seed)
    shape = (batch * batches, cfg["seq"])
    x = rng.randint(0, cfg["vocab"], shape).astype(np.float32)
    y = rng.randint(0, cfg["vocab"], shape).astype(np.float32)
    return x, y


def lstm_setup(cfg, batch, batches, device=None, seed=SEED, symbol=None):
    """(Module of ``symbol`` (default :func:`lstm_symbol`) on ``device``
    (None = the card), bound for ``batch`` and initialized by Xavier
    drawing from ``seed``; an NDArrayIter over :func:`lstm_data` from
    ``seed + 1``; that initializer)."""
    from .. import initializer, io
    from ..module import Module

    mod = Module(lstm_symbol(cfg) if symbol is None else symbol,
                 context=device)
    x, y = lstm_data(cfg, batch, batches, seed + 1)
    it = io.NDArrayIter(x, y, batch_size=batch)
    init = initializer.Xavier(rng=np.random.RandomState(seed))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    return mod, it, init


def fit_args(cfg, init):
    """``Module.fit`` keyword arguments of the run: one epoch of plain SGD
    at ``cfg``'s learning rate, ``init``, Perplexity."""
    from .. import metric

    return {"num_epoch": 1, "optimizer": "sgd",
            "optimizer_params": (("learning_rate", cfg["lr"]),),
            "initializer": init,
            "eval_metric": metric.Perplexity(ignore_label=None)}


def lstm_steps(cfg, batches):
    """``lstm_step`` launches of ``batches`` forwards: one per layer and
    time step."""
    return cfg["layers"] * cfg["seq"] * batches
