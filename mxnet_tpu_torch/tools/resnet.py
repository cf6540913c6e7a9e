"""The ResNet-50 training run the card scripts drive.

``chip_smoke.py`` (its ``resnet`` phase) and
:mod:`mxnet_tpu_torch.tools.profile_module` train bench.py's headline
model through ``Module.fit``: ``models.get_symbol("resnet-50",
num_classes=1000)`` on 3 x 224 x 224 images, in ``dtype`` (bench.py's
bf16 compute over f32 weights, ``BENCH_DTYPE``), ``Xavier(factor_type=
"in", magnitude=2)`` and SGD lr 0.05 / momentum 0.9 / wd 1e-4
(``bench.py:117-181``), at batch 32, the reference MXNet's per-GPU batch
(``BENCH_BATCH=32``), over ``batches`` seeded batches of ``uniform(-1, 1)``
images and random labels (``bench.py:167-169``). The card-vs-CPU check
runs the same model in f32 at ``check_batch`` for ``check_steps``
batches. All take the configuration and the set-up from here.
"""
from __future__ import annotations

import numpy as np

RESNET = {"depth": 50, "classes": 1000, "image": (3, 224, 224),
          "batch": 32, "batches": 8, "lr": 0.05, "momentum": 0.9,
          "wd": 1e-4, "dtype": "bfloat16", "check_batch": 2,
          "check_steps": 2}
SEED = 0


def resnet_symbol(cfg):
    from .. import models

    return models.get_symbol("resnet-%d" % cfg["depth"],
                             num_classes=cfg["classes"],
                             image_shape=cfg["image"])


def resnet_data(cfg, batch, batches, seed):
    """Seeded host data: ``batch * batches`` images of uniform(-1, 1) and
    labels in [0, classes), both f32."""
    rng = np.random.RandomState(seed)
    n = batch * batches
    x = rng.uniform(-1, 1, (n,) + tuple(cfg["image"])).astype(np.float32)
    y = rng.randint(0, cfg["classes"], n).astype(np.float32)
    return x, y


def resnet_setup(cfg, batch, batches, device=None, seed=SEED,
                 compute_dtype=None):
    """(Module on ``device`` (None = the card) computing in
    ``compute_dtype``, NDArrayIter over :func:`resnet_data` from ``seed +
    1``, Xavier initializer drawing from ``seed``)."""
    from .. import initializer, io
    from ..module import Module

    mod = Module(resnet_symbol(cfg), context=device,
                 compute_dtype=compute_dtype)
    x, y = resnet_data(cfg, batch, batches, seed + 1)
    it = io.NDArrayIter(x, y, batch_size=batch)
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    return mod, it, init


def fit_args(cfg, init):
    """``Module.fit`` keyword arguments of the run: one epoch of SGD
    momentum with ``cfg``'s hyperparameters, ``init``, acc and ce."""
    return {"num_epoch": 1, "optimizer": "sgd",
            "optimizer_params": (("learning_rate", cfg["lr"]),
                                 ("momentum", cfg["momentum"]),
                                 ("wd", cfg["wd"])),
            "initializer": init, "eval_metric": ["acc", "ce"]}


def change_err(change, ref_change):
    """How far a parameter's (or aux state's) change over training lies
    from the reference's: ||change - ref_change|| / ||ref_change||, or
    ||change|| where the reference does not move. The measure the resnet
    card-vs-CPU check gates on."""
    change = np.asarray(change, np.float64)
    ref_change = np.asarray(ref_change, np.float64)
    scale = np.linalg.norm(ref_change)
    diff = np.linalg.norm(change - ref_change)
    return float(diff / scale if scale > 0 else diff)


def wgrad_convs(sym):
    """How many convolutions of ``sym`` take their weight gradient from
    the conv_wgrad kernels (``ops.nn.takes_wgrad``: the 3x3 windows of one
    group, dilation, stride and pad): each launches them once per
    step."""
    from ..ops.nn import takes_wgrad

    return sum(1 for n in sym._nodes() if not n.is_var
               and n.op.name == "Convolution" and takes_wgrad(n.attrs))


def resnet_params(cfg, seed=SEED):
    """Seeded inference weights for ``cfg``'s ResNet as one numpy dict
    (``arg:`` / ``aux:`` prefixed, the Predictor's form): the run's
    ``Xavier(factor_type="in", magnitude=2)`` drawn from ``seed`` in
    ``Module.init_params``' order (sorted names), batch norm's moving
    means 0 and variances 1."""
    from .. import initializer, nd

    sym = resnet_symbol(cfg)
    shapes, _, aux_shapes = sym.infer_shape(
        data=(1,) + tuple(cfg["image"]), softmax_label=(1,))
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    args = dict(zip(sym.list_arguments(), shapes))
    params = {}
    for n in sorted(args):
        if n in ("data", "softmax_label"):
            continue
        arr = nd.zeros(args[n], ctx="cpu")
        init(initializer.InitDesc(n), arr)
        params["arg:" + n] = arr.asnumpy()
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        params["aux:" + n] = np.full(s, 1.0 if n.endswith("var") else 0.0,
                                     np.float32)
    return params
