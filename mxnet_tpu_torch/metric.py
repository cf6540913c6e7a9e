"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference python/mxnet/metric.py)
for ``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``F1`` (binary), ``Perplexity``, ``MAE`` / ``MSE`` /
``RMSE``, ``CrossEntropy``, ``Loss`` (and its ``Torch`` / ``Caffe``
names), ``CustomMetric`` / ``np`` and ``create``. Metrics read labels and
predictions on the host (``asnumpy``): that copy is the one sync point per
training step, as in the reference.
"""
from __future__ import annotations

import math

import numpy

from .ndarray import NDArray


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))


class EvalMetric:
    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = metrics or []

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            names.append(name)
            results.append(result)
        return (names, results)


class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred, lab = _host(pred_label), _host(label)
            if pred.shape != lab.shape:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype(numpy.int32).flatten()
            lab = lab.astype(numpy.int32).flatten()
            check_label_shapes(lab, pred, shape=1)
            self.sum_metric += (pred == lab).sum()
            self.num_inst += len(pred)


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Use Accuracy if top_k <= 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _host(pred_label).astype("float32")
            lab = _host(label).astype("int32")
            if pred.ndim > 2:
                raise ValueError("Predictions should be no more than 2 dims")
            pred = numpy.argsort(pred)
            if pred.ndim == 1:
                self.sum_metric += (pred.flatten() == lab.flatten()).sum()
            else:
                num_classes = pred.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += (pred[:, num_classes - 1 - j].flatten()
                                        == lab.flatten()).sum()
            self.num_inst += pred.shape[0]


class F1(EvalMetric):
    """F1 of a binary classifier (argmax over axis 1), averaged over
    batches."""

    def __init__(self, name="f1"):
        super().__init__(name)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred_label = numpy.argmax(_host(pred), axis=1)
            label = _host(label).astype("int32")
            check_label_shapes(label, pred_label, shape=1)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = float(numpy.sum((pred_label == 1) & (label == 1)))
            fp = float(numpy.sum((pred_label == 1) & (label == 0)))
            fn = float(numpy.sum((pred_label == 0) & (label == 1)))
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
            self.sum_metric += f1
            self.num_inst += 1


class Perplexity(EvalMetric):
    """Perplexity, optionally ignoring one label value."""

    def __init__(self, ignore_label=None, axis=-1, name="Perplexity"):
        super().__init__(name)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        loss, num = 0.0, 0
        for label, pred in zip(labels, preds):
            pred, label = _host(pred), _host(label)
            if label.size != pred.size / pred.shape[-1]:
                raise ValueError("Perplexity: %d labels for %s predictions"
                                 % (label.size, pred.shape))
            label = label.reshape(-1).astype(numpy.int64)
            pred = pred.reshape(-1, pred.shape[-1])
            # ignored labels (e.g. -1) must not index a real class; their
            # probability is replaced by 1 below
            label_idx = (numpy.clip(label, 0, pred.shape[-1] - 1)
                         if self.ignore_label is not None else label)
            probs = pred[numpy.arange(label.size), label_idx]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(pred.dtype)
                num -= int(numpy.sum(ignore))
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        self.sum_metric += math.exp(loss / max(num, 1)) * max(num, 1)
        self.num_inst += max(num, 1)


def _regression_pairs(labels, preds):
    """(label, pred) host arrays, a 1-D label as a column."""
    check_label_shapes(labels, preds)
    for label, pred in zip(labels, preds):
        label = _host(label)
        if label.ndim == 1:
            label = label.reshape(label.shape[0], 1)
        yield label, _host(pred)


class MAE(EvalMetric):
    """Mean absolute error, averaged over batches."""

    def __init__(self, name="mae"):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    """Mean squared error, averaged over batches."""

    def __init__(self, name="mse"):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


class RMSE(EvalMetric):
    """Root mean squared error, averaged over batches."""

    def __init__(self, name="rmse"):
        super().__init__(name)

    def update(self, labels, preds):
        for label, pred in _regression_pairs(labels, preds):
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _host(label).ravel(), _host(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d rows"
                                 % (label.shape[0], pred.shape[0]))
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of the raw outputs (for MakeLoss-style heads)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += _host(pred).sum()
            self.num_inst += pred.size


class Torch(Loss):
    """``Loss`` under the reference's name for its Torch plugin's losses."""

    def __init__(self, name="torch"):
        super().__init__(name)


class Caffe(Loss):
    """``Loss`` under the reference's name for its Caffe plugin's
    losses."""

    def __init__(self, name="caffe"):
        super().__init__(name)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_host(label), _host(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A metric from a numpy ``feval(label, pred)``."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


_METRICS = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
            "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
            "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
            "loss": Loss}


def create(metric, **kwargs):
    """A metric from a name, a callable, a list (composite) or an
    instance."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    try:
        klass = _METRICS[metric.lower()]
    except KeyError:
        raise ValueError("Metric must be either callable or in %s"
                         % sorted(_METRICS)) from None
    return klass(**kwargs)
