"""The SSD training and detection runs the card scripts drive.

``chip_smoke.py`` (its ``ssd`` phase) trains and serves MXNet's SSD
(example/ssd; ``models.get_symbol("ssd-vgg16")``) at SSD300 width:

- ``SSD`` (the run): 20 classes (VOC's), 3 x 300 x 300 images, 1,756
  anchors (4 a position over 18^2, 9^2, 5^2 and 3^2), in bf16 compute over
  f32 weights, batch 32, 8 seeded batches, SGD (example/ssd's lr 0.004,
  momentum 0.9, wd 5e-4) through ``Module.fit`` and the captured fit step;
  then the detection symbol through ``Predictor`` at batch 1 and 8;
- the card-vs-CPU check: the same model in f32, 2 batches of 2.

The data are seeded: images uniform(-1, 1) and 1-8 boxes an image with
random classes, labels (B, 8, 5) [class, xmin, ymin, xmax, ymax] padded
with -1 rows, the layout ``MultiBoxTarget`` reads. No dataset is read, so
no claim on VOC mAP rests on these runs. The metric is example/ssd's
``MultiBoxMetric``: the cross-entropy of the class probabilities at the
class targets and the summed smooth L1 location loss, each over the
anchors with a target.

The module also holds the gates' host arithmetic: which anchors a
matching may flip (an IoU at the threshold, two ground truths tied) and
whether a difference of keep masks follows a near-degenerate NMS choice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..metric import EvalMetric
from ..ops.contrib import iou_matrix
from .resnet import SEED

SSD = {"model": "ssd-vgg16", "classes": 20, "image": (3, 300, 300),
       "max_boxes": 8, "batch": 32, "batches": 8, "lr": 0.004,
       "momentum": 0.9, "wd": 5e-4, "dtype": "bfloat16",
       "check_batch": 2, "check_steps": 2, "detect_batches": (1, 8),
       "nms_threshold": 0.5, "nms_topk": 400, "overlap_threshold": 0.5}


def ssd_symbol(cfg=SSD, mode="train"):
    """``ssd-vgg16`` with ``cfg``'s classes, built in a fresh name scope."""
    from .. import models
    from ..name import NameManager

    with NameManager():
        return models.get_symbol(cfg["model"], num_classes=cfg["classes"],
                                 mode=mode, nms_threshold=cfg["nms_threshold"],
                                 nms_topk=cfg["nms_topk"])


def ssd_labels(rng, batch, rows, classes):
    """(batch, rows, 5) f32 ground truth: 1..rows boxes an image, classes
    in [0, classes), corners in [0, 1] with sides of 0.1-0.6, the rest -1
    rows."""
    lab = np.full((batch, rows, 5), -1.0, np.float32)
    for b in range(batch):
        n = rng.randint(1, rows + 1)
        wh = rng.uniform(0.1, 0.6, (n, 2))
        x0 = rng.uniform(0, 1, (n, 2)) * (1 - wh)
        lab[b, :n, 0] = rng.randint(0, classes, n)
        lab[b, :n, 1:] = np.concatenate([x0, x0 + wh], axis=1)
    return lab


def ssd_data(cfg, batch, batches, seed):
    """``batch * batches`` seeded images of ``cfg["image"]`` (uniform(-1,
    1), f32) and their labels (:func:`ssd_labels`)."""
    rng = np.random.RandomState(seed)
    n = batch * batches
    x = rng.uniform(-1, 1, (n,) + tuple(cfg["image"])).astype(np.float32)
    return x, ssd_labels(rng, n, cfg["max_boxes"], cfg["classes"])


def ssd_setup(cfg, batch, batches, device=None, seed=SEED,
              compute_dtype=None):
    """(Module of the train symbol on ``device`` (None = the card)
    computing in ``compute_dtype``, NDArrayIter over :func:`ssd_data` from
    ``seed + 1`` with the label named ``label``, Xavier initializer drawing
    from ``seed``)."""
    from .. import initializer, io
    from ..module import Module

    mod = Module(ssd_symbol(cfg), data_names=("data",),
                 label_names=("label",), context=device,
                 compute_dtype=compute_dtype)
    x, y = ssd_data(cfg, batch, batches, seed + 1)
    it = io.NDArrayIter(x, y, batch_size=batch, label_name="label")
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    return mod, it, init


class MultiBoxMetric(EvalMetric):
    """example/ssd's training metric over the train symbol's outputs
    [cls_prob (B, C, A), loc_loss, cls_target (B, A)]: the mean
    cross-entropy of the class probabilities at the anchors' class targets
    and the summed smooth L1 location loss over the same count, both over
    the anchors whose target is not -1 (every anchor in this port: no
    anchor is ignored). Names ``cross-entropy`` and ``smooth_l1``."""

    def __init__(self, eps=1e-8):
        self.eps = eps
        super().__init__("multibox", num=2)

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy().astype(np.float64)
        loc_loss = preds[1].asnumpy().astype(np.float64)
        target = preds[2].asnumpy().reshape(-1)
        valid = np.flatnonzero(target >= 0)
        prob = cls_prob.transpose(0, 2, 1).reshape(
            -1, cls_prob.shape[1])[valid, target[valid].astype(int)]
        self.sum_metric[0] += float(-np.log(prob + self.eps).sum())
        self.num_inst[0] += valid.size
        self.sum_metric[1] += float(loc_loss.sum())
        self.num_inst[1] += valid.size

    def get(self):
        return ["cross-entropy", "smooth_l1"], super().get()[1]


def fit_args(cfg, init):
    """``Module.fit`` keyword arguments of the run: one epoch of SGD
    momentum with ``cfg``'s hyperparameters, ``init``, the multibox
    metric."""
    return {"num_epoch": 1, "optimizer": "sgd",
            "optimizer_params": (("learning_rate", cfg["lr"]),
                                 ("momentum", cfg["momentum"]),
                                 ("wd", cfg["wd"])),
            "initializer": init, "eval_metric": MultiBoxMetric()}


def feature_shapes(cfg=SSD, batch=1):
    """The (B, C, H, W) shapes of the four feature maps the heads read,
    in order (the inputs of the ``anchors_i`` MultiBoxPrior nodes)."""
    sym = ssd_symbol(cfg, "detect")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(batch,) + tuple(cfg["image"]))
    shapes = dict(zip(internals.list_outputs(), outs))
    out = []
    for node in sym._nodes():
        if not node.is_var and node.op.name == "MultiBoxPrior":
            src, i = node.inputs[0]
            out.append(shapes["%s_%s" % (
                src.name, src.op.get_output_names(src.attrs)[i])])
    return out


def ssd_targets(cfg, labels, device):
    """The model's anchors (its four MultiBoxPrior ops on ``device``, None
    the card, concatenated) and ``MultiBoxTarget``'s (loc_target,
    loc_mask, cls_target) for ``labels`` on ``device``, as host arrays."""
    import torch

    from ..models import ssd as ssd_model
    from ..ops import registry as treg

    from ..context import resolve_device

    dev = resolve_device(device)
    prior, target = treg.get_op("MultiBoxPrior"), treg.get_op(
        "MultiBoxTarget")
    ctx = treg.OpContext(False, dev)
    parts = []
    for i, shape in enumerate(feature_shapes(cfg)):
        attrs = prior.parse_attrs({"sizes": ssd_model._SIZES[i],
                                   "ratios": ssd_model._RATIOS[i],
                                   "clip": True})
        (a,), _ = prior.impl(attrs, (torch.zeros(shape, device=dev),), (),
                             ctx)
        parts.append(a)
    anchors = torch.cat(parts, dim=1)
    lab = torch.tensor(labels, device=dev)
    cls_pred = torch.zeros((lab.shape[0], cfg["classes"] + 1,
                            anchors.shape[1]), device=dev)
    outs, _ = target.impl(target.parse_attrs(
        {"overlap_threshold": cfg["overlap_threshold"],
         "negative_mining_ratio": 3.0}), (anchors, lab, cls_pred), (), ctx)
    return (anchors.cpu().numpy(),) + tuple(o.cpu().numpy() for o in outs)


def iou_np(a, b):
    """IoU of corner boxes a (N, 4) against b (M, 4) in f64: (N, M), the
    ops' own arithmetic (``ops.contrib.iou_matrix``)."""
    return iou_matrix(torch.as_tensor(np.asarray(a, np.float64)),
                      torch.as_tensor(np.asarray(b, np.float64))).numpy()


def matching_excused(anchors, labels, thresh, iou_margin=1e-5,
                     tie_margin=1e-6):
    """(B, A) bool: the anchors whose matching the rounding of two
    devices may flip: best IoU within ``iou_margin`` of ``thresh``, or at
    least that and their two best ground truths' IoUs within
    ``tie_margin``; and the anchors some ground truth's best-anchor
    choice is that close to another anchor's (a forced match may move
    between them)."""
    anchors = np.asarray(anchors).reshape(-1, 4)
    out = np.zeros((labels.shape[0], anchors.shape[0]), bool)
    for b, lab in enumerate(labels):
        gt = lab[lab[:, 0] >= 0, 1:5]
        iou = iou_np(anchors, gt)                       # (A, G)
        top = np.sort(iou, axis=1)[:, ::-1]
        out[b] = np.abs(top[:, 0] - thresh) < iou_margin
        if gt.shape[0] > 1:
            # which ground truth matches matters only to an anchor that
            # may reach the threshold
            out[b] |= ((top[:, 0] - top[:, 1]) < tie_margin) & \
                (top[:, 0] >= thresh - iou_margin)
        # a ground truth whose best anchor is nearly tied: its forced
        # match may move among those anchors
        near = np.abs(iou - iou.max(axis=0)[None, :]) < tie_margin
        out[b] |= (near & (near.sum(axis=0) > 1)[None, :]).any(axis=1)
    return out


def nms_explained(boxes, scores, valid, keep_a, keep_b, thresh,
                  score_margin=1e-6, iou_margin=1e-5):
    """Whether keep masks ``keep_a`` and ``keep_b`` of one image (the same
    NMS on two devices' nearly equal inputs) differ only after a choice
    their rounding may flip. Greedy NMS takes boxes in falling score
    order, so the first difference lies at the highest-scored anchor
    where the masks differ; it is explained if, among the valid boxes
    scored at least that high (less ``score_margin``), two scores lie
    within ``score_margin`` of each other or two boxes' IoU within
    ``iou_margin`` of ``thresh``. Returns (explained, anchors that differ,
    the score of the first)."""
    diff = np.flatnonzero(keep_a != keep_b)
    if diff.size == 0:
        return True, 0, None
    scores = np.asarray(scores, np.float64)
    first = float(scores[diff].max())
    top = np.flatnonzero(valid & (scores >= first - score_margin))
    s = np.sort(scores[top])
    near_tie = s.size > 1 and bool((np.diff(s) < score_margin).any())
    iou = iou_np(boxes[top], boxes[top])
    np.fill_diagonal(iou, -1.0)
    near_thresh = bool((np.abs(iou - thresh) < iou_margin).any())
    return near_tie or near_thresh, int(diff.size), first
