"""The sequence-classifier training run the card scripts drive.

``chip_smoke.py`` (its ``seq`` phase) trains the LSTM LM's body at its
width (``tools/lstm_lm.py``: vocab 10000, embed = hidden = 512, 2 fused
LSTM layers, seq 35, f32) under a classifier head that reads each
sequence's last valid step: ``RNN`` output (NTC) -> ``SequenceMask``
(``use_sequence_length``, axis 1) -> ``SequenceLast``
(``use_sequence_length``, axis 1) -> ``FullyConnected(classes)`` ->
``SoftmaxOutput``. The data are seeded token ids (as f32), a length a
sequence uniform in ``1..seq`` and a class a sequence; ``Module.fit``
trains with SGD (momentum) under ``FactorScheduler(factor_step,
factor)``, ``Xavier`` from the seed, a Perplexity metric. The random ops'
draws run at ``random_elements`` elements.

``pkg`` is the package whose ``sym`` / ``rnn`` / ``lr_scheduler`` build the
run (default: this one), so a CPU test builds the same run in the JAX
package.
"""
from __future__ import annotations

import numpy as np

SEQ = {"vocab": 10000, "embed": 512, "hidden": 512, "layers": 2, "seq": 35,
       "classes": 10, "batch": 128, "batches": 8, "lr": 0.1,
       "momentum": 0.9, "factor_step": 2, "factor": 0.5,
       "check_batch": 8, "check_steps": 2, "random_elements": 1 << 20}
SEED = 0
DATA_NAMES = ("data", "seq_len")


def _pkg(pkg):
    if pkg is None:
        import mxnet_tpu_torch as pkg
    return pkg


def seq_symbol(cfg, pkg=None):
    """The classifier: embed -> fused LSTM stack (NTC) -> SequenceMask ->
    SequenceLast -> FullyConnected -> SoftmaxOutput."""
    pkg = _pkg(pkg)
    sym = pkg.sym
    data = sym.Variable("data")                  # (batch, seq) ids
    lens = sym.Variable("seq_len")               # (batch,)
    embed = sym.Embedding(data=data, input_dim=cfg["vocab"],
                          output_dim=cfg["embed"], name="embed")
    stack = pkg.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                                 mode="lstm", prefix="lstm_")
    outputs, _ = stack.unroll(cfg["seq"], inputs=embed, merge_outputs=True,
                              layout="NTC")
    masked = sym.SequenceMask(data=outputs, sequence_length=lens,
                              use_sequence_length=True, axis=1,
                              name="mask")
    last = sym.SequenceLast(data=masked, sequence_length=lens,
                            use_sequence_length=True, axis=1, name="last")
    pred = sym.FullyConnected(data=last, num_hidden=cfg["classes"],
                              name="cls")
    return sym.SoftmaxOutput(data=pred, name="softmax")


def seq_data(cfg, batch, batches, seed):
    """Seeded host arrays of ``batch * batches`` sequences: token ids
    ``randint(0, vocab)``, lengths ``randint(1, seq + 1)`` and classes
    ``randint(0, classes)``, all f32."""
    rng = np.random.RandomState(seed)
    n = batch * batches
    x = rng.randint(0, cfg["vocab"], (n, cfg["seq"])).astype(np.float32)
    lens = rng.randint(1, cfg["seq"] + 1, n).astype(np.float32)
    y = rng.randint(0, cfg["classes"], n).astype(np.float32)
    return x, lens, y


def seq_iter(cfg, batch, batches, seed, pkg=None):
    """An NDArrayIter over :func:`seq_data` from ``seed``."""
    x, lens, y = seq_data(cfg, batch, batches, seed)
    return _pkg(pkg).io.NDArrayIter({"data": x, "seq_len": lens},
                                    {"softmax_label": y}, batch_size=batch)


def seq_setup(cfg, batch, batches, device=None, seed=SEED):
    """(Module of :func:`seq_symbol` on ``device`` (None = the card),
    bound for ``batch`` and initialized by Xavier drawing from ``seed``;
    its iterator from ``seed + 1``; that initializer)."""
    from .. import initializer
    from ..module import Module

    mod = Module(seq_symbol(cfg), data_names=DATA_NAMES, context=device)
    it = seq_iter(cfg, batch, batches, seed + 1)
    init = initializer.Xavier(rng=np.random.RandomState(seed))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    return mod, it, init


def fit_args(cfg, init, pkg=None):
    """``Module.fit`` keyword arguments of the run: one epoch of SGD with
    momentum under a fresh ``FactorScheduler``, ``init``, Perplexity."""
    pkg = _pkg(pkg)
    sched = pkg.lr_scheduler.FactorScheduler(step=cfg["factor_step"],
                                             factor=cfg["factor"])
    return {"num_epoch": 1, "optimizer": "sgd",
            "optimizer_params": (("learning_rate", cfg["lr"]),
                                 ("momentum", cfg["momentum"]),
                                 ("lr_scheduler", sched)),
            "initializer": init,
            "eval_metric": pkg.metric.Perplexity(ignore_label=None)}


def lr_sequence(cfg, steps):
    """The learning rate of each of ``steps`` updates under the schedule:
    ``lr * factor ** ((k - 1) // factor_step)`` at update ``k``, computed
    as the scheduler computes it (repeated products)."""
    out, lr = [], cfg["lr"]
    for k in range(1, steps + 1):
        if k > 1 and (k - 1) % cfg["factor_step"] == 0:
            lr *= cfg["factor"]
        out.append(lr)
    return out


def moments(name, attrs):
    """(mean, variance, fourth central moment) of a sampling op's
    distribution."""
    if name == "_random_uniform":
        w = attrs["high"] - attrs["low"]
        return (attrs["low"] + attrs["high"]) / 2, w * w / 12, w ** 4 / 80
    if name == "_random_normal":
        s2 = attrs["scale"] ** 2
        return attrs["loc"], s2, 3 * s2 * s2
    if name == "_random_gamma":
        a, b = attrs["alpha"], attrs["beta"]
        return a * b, a * b * b, 3 * a * (a + 2) * b ** 4
    if name == "_random_exponential":
        lam = attrs["lam"]
        return 1 / lam, 1 / lam ** 2, 9 / lam ** 4
    raise ValueError(name)


#: the sampling ops the phase draws, with their parameters
RANDOM_OPS = (("_random_uniform", {"low": -1.0, "high": 3.0}),
              ("_random_normal", {"loc": 0.5, "scale": 2.0}),
              ("_random_gamma", {"alpha": 2.5, "beta": 0.5}),
              ("_random_exponential", {"lam": 4.0}))
