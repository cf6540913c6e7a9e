"""The image-classification zoo runs the card scripts drive.

``chip_smoke.py`` (its ``image_zoo`` phase) trains the models of MXNet's
``example/image-classification`` through ``Module.fit``:

- ``IMAGE_ZOO["main"]``: Inception-BN, MXNet's own ImageNet model,
  ``models.get_symbol("inception-bn", num_classes=1000)`` on 3 x 224 x
  224, in bf16 compute over f32 weights, at batch 32 (the reference's
  per-GPU batch) for 8 seeded batches, with ``tools/resnet.py``'s
  initializer and SGD (lr 0.05, momentum 0.9, wd 1e-4);
- ``IMAGE_ZOO["check"]``: each of the seven models at its published input
  (224; 299 for inception-v3 and inception-resnet-v2), 1000 classes, f32,
  2 batches of 2, on the card and on the CPU from the same weights, with
  every ``Dropout`` held at p = 0 (the two devices draw different masks):
  the symbol goes to JSON, each Dropout's ``p`` is set to 0 there, and the
  JSON is loaded back.

All take the configuration and the set-up from here. The data are
``tools/resnet.py``'s: seeded uniform(-1, 1) images and random labels.
"""
from __future__ import annotations

import json

import numpy as np

from .resnet import SEED, resnet_data

IMAGE_ZOO = {
    "main": {"model": "inception-bn", "classes": 1000,
             "image": (3, 224, 224), "batch": 32, "batches": 8, "lr": 0.05,
             "momentum": 0.9, "wd": 1e-4, "dtype": "bfloat16"},
    # model -> input side; the seven models of the zoo, vgg as vgg16 and
    # resnext as resnext-50
    "check": {"alexnet": 224, "vgg16": 224, "googlenet": 224,
              "inception-bn": 224, "inception-v3": 299,
              "inception-resnet-v2": 299, "resnext-50": 224},
    "check_batch": 2, "check_steps": 2, "classes": 1000, "lr": 0.05,
    "momentum": 0.9, "wd": 1e-4,
    # batch of the conv_wgrad shape table (every eligible 3x3 of the
    # seven models at full width)
    "wgrad_batch": 32,
}


def without_dropout(sym):
    """``sym`` with every Dropout's ``p`` set to 0, through its JSON."""
    from .. import symbol

    graph = json.loads(sym.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attrs"]["p"] = "0.0"
    return symbol.load_json(json.dumps(graph))


def zoo_symbol(name, classes):
    """``models.get_symbol(name)`` with ``classes`` outputs and no
    dropout, built in a fresh name scope: the layers a builder leaves
    unnamed (inception-resnet-v2's) get the same names every time."""
    from .. import models
    from ..name import NameManager

    with NameManager():
        return without_dropout(models.get_symbol(name, num_classes=classes))


# ops that carry a per-channel constant added to their (first) input on to
# their output as a per-channel constant
_SHIFT_THROUGH = ("elemwise_add", "_plus", "broadcast_add", "add_n",
                  "_mul_scalar", "_div_scalar", "Concat")


def _passes_shift(node):
    """Whether ``node`` turns a per-channel constant on an input into one
    on its output: the adds, scalings and channel concatenations, a 1 x 1
    convolution without padding, max pooling and the global pools."""
    op, attrs = node.op.name, node.attrs
    if op in _SHIFT_THROUGH:
        return True
    if op == "Convolution":
        return all(int(k) == 1 for k in attrs["kernel"]) and \
            not any(int(p) for p in (attrs["pad"] or ()))
    if op == "Pooling":
        return attrs["pool_type"] == "max" or attrs["global_pool"]
    return op == "Dropout" and attrs["p"] == 0.0


def dead_shifts(sym):
    """The shift parameters (Convolution / FullyConnected biases, batch
    norm betas) whose per-channel constant reaches nothing but batch norms
    in training, which subtract each channel's mean: their gradient is
    zero in exact arithmetic, their updates are rounding noise, and they
    change no output."""
    consumers = {}
    for node in sym._nodes():
        for child, _ in node.inputs:
            consumers.setdefault(id(child), []).append(node)
    memo = {}

    def removed(node):
        """Whether a per-channel constant on ``node``'s output is removed
        before it reaches anything but a batch norm."""
        if id(node) not in memo:
            users = consumers.get(id(node), [])
            memo[id(node)] = bool(users) and all(
                (u.op.name == "BatchNorm" and u.inputs[0][0] is node
                 and not u.attrs["use_global_stats"])
                or (_passes_shift(u) and removed(u)) for u in users)
        return memo[id(node)]

    names = []
    for node in sym._nodes():
        if node.is_var:
            continue
        op = node.op.name
        slot = {"Convolution": 2, "FullyConnected": 2, "BatchNorm": 2}.get(op)
        if slot is None or len(node.inputs) <= slot or \
                (op != "BatchNorm" and node.attrs["no_bias"]):
            continue
        if removed(node):
            names.append(node.inputs[slot][0].name)
    return names


def image_cfg(cfg, side):
    """``cfg`` (a run's configuration) for square images of ``side``."""
    return dict(cfg, image=(3, side, side))


def zoo_setup(name, cfg, batch, batches, device=None, seed=SEED,
              compute_dtype=None):
    """(Module of ``name`` on ``device`` (None = the card) computing in
    ``compute_dtype``, NDArrayIter over ``batch * batches`` seeded images
    of ``cfg["image"]`` from ``seed + 1``, Xavier initializer drawing from
    ``seed``), as ``tools/resnet.py`` sets up ResNet-50."""
    from .. import initializer, io
    from ..module import Module

    mod = Module(zoo_symbol(name, cfg["classes"]), context=device,
                 compute_dtype=compute_dtype)
    x, y = resnet_data(cfg, batch, batches, seed + 1)
    it = io.NDArrayIter(x, y, batch_size=batch)
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    return mod, it, init


def wgrad_shapes(sym, image, batch):
    """The conv_wgrad calls of one step of ``sym`` on ``batch`` images of
    ``image``: {(n, h, w, c, k, stride, pad): count} of every convolution
    the Convolution op routes to the kernel (``ops.nn.takes_wgrad``)."""
    from ..ops.nn import takes_wgrad

    internals = sym.get_internals()
    # partial: a detector's label is not needed up to its convolutions
    _, outs, _ = internals.infer_shape_partial(data=(batch,) + tuple(image))
    shapes = dict(zip(internals.list_outputs(), outs))
    counts = {}
    for node in sym._nodes():
        if node.is_var or node.op.name != "Convolution" or \
                not takes_wgrad(node.attrs):
            continue
        src, i = node.inputs[0]
        if src.is_var:
            c, h, w = image
        else:
            name = src.op.get_output_names(src.attrs)[i]
            _, c, h, w = shapes["%s_%s" % (src.name, name)]
        stride = int((node.attrs["stride"] or (1,))[0])
        pad = int((node.attrs["pad"] or (0,))[0])
        key = (batch, h, w, c, int(node.attrs["num_filter"]), stride, pad)
        counts[key] = counts.get(key, 0) + 1
    return counts
