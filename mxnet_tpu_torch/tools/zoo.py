"""The optimizer-zoo training runs the card scripts drive.

``chip_smoke.py`` (its ``zoo`` phase) trains the LSTM LM of
``tools/lstm_lm.py`` at its width (vocab 10000, embed = hidden = 512, 2
fused LSTM layers, seq 35, f32, ``Xavier`` from the seed, a Perplexity
metric) through ``Module.fit`` under each optimizer of :data:`OPTIMIZERS`:
the reference's defaults, with a learning rate each that keeps 8 batches
of 128 finite, momentum 0.9 where the optimizer has one. Beside it the
same LM split into a ``SequentialModule``: :func:`body_symbol` (embedding
and the fused LSTM, up to the hidden states reshaped to (batch * seq,
hidden)) and :func:`head_symbol` (``FullyConnected(vocab)`` +
``SoftmaxOutput``, with ``take_labels``); or the body with the
``FullyConnected`` and a ``PythonLossModule`` head whose gradient is
``SoftmaxOutput``'s, :func:`softmax_grad`, under :func:`logit_perplexity`.
The parameter names are the single module's, and ``init_params`` draws
them in the same sorted order, so one seed gives both the same weights.

``pkg`` is the package that builds the run (default: this one), so a CPU
test builds the same run in the JAX package.
"""
from __future__ import annotations

import numpy as np

from .lstm_lm import LSTM_LM, SEED, lstm_data

ZOO = dict(LSTM_LM, check_batch=8, check_steps=2, monitor_interval=2,
           monitor_batches=4, feedforward_batches=2, sgld_lr=0.01)

#: (run, registry name, hyperparameters): every optimizer of the
#: reference's registry, RMSProp both plain and centered
OPTIMIZERS = (
    ("sgd", "sgd", {"learning_rate": 0.5, "momentum": 0.9}),
    ("nag", "nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("ccsgd", "ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("dcasgd", "dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", "adam", {"learning_rate": 0.001}),
    ("adagrad", "adagrad", {"learning_rate": 0.01}),
    ("rmsprop", "rmsprop", {"learning_rate": 0.001}),
    ("rmsprop_centered", "rmsprop", {"learning_rate": 0.001,
                                     "centered": True}),
    ("adadelta", "adadelta", {}),
    ("ftrl", "ftrl", {"learning_rate": 0.1}),
    ("sgld", "sgld", {"learning_rate": 1e-4}),
    ("test", "test", {}),
)
#: the runs whose optimizer has a pure rule: a Module's fused step
CAPTURED = ("nag", "rmsprop", "rmsprop_centered", "adagrad", "adadelta",
            "ccsgd")
#: the runs through the Updater ("has no pure rule")
UPDATER = ("ftrl", "sgld", "dcasgd", "test")


def _pkg(pkg):
    if pkg is None:
        import mxnet_tpu_torch as pkg
    return pkg


def optimizer_run(run):
    """(registry name, hyperparameters) of the run named ``run``."""
    for name, reg, params in OPTIMIZERS:
        if name == run:
            return reg, dict(params)
    raise KeyError(run)


def body_symbol(cfg, pkg=None, with_fc=False):
    """The LM up to the hidden states reshaped to (batch * seq, hidden);
    with ``with_fc`` through ``FullyConnected(vocab)`` (the logits)."""
    sym = _pkg(pkg).sym
    embed = sym.Embedding(data=sym.Variable("data"), input_dim=cfg["vocab"],
                          output_dim=cfg["embed"], name="embed")
    stack = _pkg(pkg).rnn.FusedRNNCell(cfg["hidden"],
                                       num_layers=cfg["layers"],
                                       mode="lstm", prefix="lstm_")
    outputs, _ = stack.unroll(cfg["seq"], inputs=embed, merge_outputs=True,
                              layout="NTC")
    hidden = sym.Reshape(data=outputs, shape=(-1, cfg["hidden"]))
    if not with_fc:
        return hidden
    return sym.FullyConnected(data=hidden, num_hidden=cfg["vocab"],
                              name="pred")


def head_symbol(cfg, pkg=None):
    """``FullyConnected(vocab)`` + ``SoftmaxOutput`` over ``data``, the
    labels flattened: the LM's head."""
    sym = _pkg(pkg).sym
    pred = sym.FullyConnected(data=sym.Variable("data"),
                              num_hidden=cfg["vocab"], name="pred")
    label = sym.Reshape(data=sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def chain(cfg, device=None, pkg=None, loss=False):
    """The LM as a ``SequentialModule`` on ``device`` (None: the package's
    default): body then head (``take_labels``, ``auto_wiring``); with
    ``loss`` the body with the FullyConnected then a ``PythonLossModule``
    of :func:`softmax_grad`."""
    pkg = _pkg(pkg)
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(body_symbol(cfg, pkg, with_fc=loss),
                           label_names=None, context=device))
    if loss:
        seq.add(pkg.mod.PythonLossModule(grad_func=softmax_grad(pkg)),
                take_labels=True, auto_wiring=True)
    else:
        seq.add(pkg.mod.Module(head_symbol(cfg, pkg), context=device),
                take_labels=True, auto_wiring=True)
    return seq


def softmax_grad(pkg=None):
    """grad_func(logits, labels): softmax(logits) - onehot(labels), the
    gradient ``SoftmaxOutput`` gives its input (no normalization), on the
    logits' device."""
    nd = _pkg(pkg).nd

    def grad(scores, labels):
        # the batch's labels, as the iterator gave them (on the host)
        labels = labels.as_in_context(scores.context)
        hot = nd.one_hot(labels.reshape((-1,)), depth=scores.shape[1])
        return nd.softmax(scores) - hot

    return grad


def logit_perplexity(pkg=None):
    """A metric named Perplexity over logits: exp of the batch's mean
    negative log-likelihood, computed in f64 on the host, averaged over
    batches."""
    def perplexity(label, logits):
        z = logits.astype(np.float64)
        z = z - z.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        ids = label.reshape(-1).astype(np.int64)
        return float(np.exp(-logp[np.arange(ids.size), ids].mean()))

    return _pkg(pkg).metric.CustomMetric(perplexity, name="Perplexity")


def zoo_iter(cfg, batch, batches, seed, pkg=None):
    """An NDArrayIter over ``lstm_data`` from ``seed``."""
    x, y = lstm_data(cfg, batch, batches, seed)
    return _pkg(pkg).io.NDArrayIter(x, y, batch_size=batch)


def fit_args(cfg, init, run, pkg=None, metric=None, batch=None):
    """``Module.fit`` keyword arguments of one epoch under the optimizer
    run ``run`` of :data:`OPTIMIZERS`; with ``batch``, ``rescale_grad``
    1 / batch for every module. A chain needs it: each of its modules
    takes 1 / its own first input axis by default, and the head's input
    is (batch * seq, hidden)."""
    pkg = _pkg(pkg)
    reg, params = optimizer_run(run)
    if batch is not None:
        params["rescale_grad"] = 1.0 / batch
    return {"num_epoch": 1, "optimizer": reg,
            "optimizer_params": tuple(sorted(params.items())),
            "initializer": init,
            "eval_metric": metric or pkg.metric.Perplexity(
                ignore_label=None)}


def sgld_moments(n, lr):
    """(mean, variance, their 1-sigma spreads over ``n`` elements) of one
    SGLD update at g = 0 and wd = 0: N(0, lr)."""
    return 0.0, lr, np.sqrt(lr / n), np.sqrt(2.0 / n) * lr
