"""Evaluation metrics on the host.

Counterpart of ``mxnet_tpu/metric.py`` for ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``,
``Loss`` and ``create``, with the same numbers: the math runs in numpy on
the host, on predictions copied off the device (``asnumpy``).  Every
update feeds two (sum, count) cells: the window (cleared by
``reset_local``, read by ``get``) and the run total (cleared by ``reset``,
read by ``get_global``).  The other metrics come with later slices.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "Loss", "create", "register",
           "check_label_shapes"]


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless labels and predictions pair up: their counts, or with
    ``shape=True`` their shapes.  ``wrap`` turns bare arrays into lists."""
    lhs = labels.shape if shape else len(labels)
    rhs = preds.shape if shape else len(preds)
    if lhs != rhs:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(lhs, rhs))
    if wrap:
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
    return labels, preds


def _asnumpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


class EvalMetric:
    """Base metric: subclasses implement ``update`` or, as pair metrics,
    ``_measure(label, pred) -> (sum, count)``."""

    def __init__(self, name, output_names=None, label_names=None):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def reset(self):
        self._win = [0.0, 0]
        self._run = [0.0, 0]

    def reset_local(self):
        self._win = [0.0, 0]

    def _accumulate(self, value, count):
        self._win[0] += value
        self._win[1] += count
        self._run[0] += value
        self._run[1] += count

    @property
    def sum_metric(self):
        return self._win[0]

    @property
    def num_inst(self):
        return self._win[1]

    def _read(self, cell):
        total, count = cell
        if count == 0:
            return (self.name, float("nan"))
        return (self.name, total / count)

    def get(self):
        return self._read(self._win)

    def get_global(self):
        return self._read(self._run)

    @staticmethod
    def _pairs(reading):
        name, value = reading
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))

    def get_name_value(self):
        return self._pairs(self.get())

    def get_global_name_value(self):
        return self._pairs(self.get_global())

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for lab, prd in zip(labels, preds):
            self._accumulate(*self._measure(_asnumpy(lab), _asnumpy(prd)))

    def _measure(self, label, pred):
        raise NotImplementedError()

    def update_dict(self, label, pred):
        """Update from {name: array} dicts, taking this metric's output
        and label names when it has them."""
        outs = list(pred.values()) if self.output_names is None \
            else [pred[n] for n in self.output_names]
        labs = list(label.values()) if self.label_names is None \
            else [label[n] for n in self.label_names]
        self.update(labs, outs)


_METRIC_REGISTRY = {}


def register(klass, *aliases):
    if not isinstance(klass, type):
        raise TypeError("register takes a class")
    for n in (klass.__name__,) + aliases:
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from its name, an instance, or a list of those (a
    CompositeEvalMetric)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, *args, **kwargs))
        return out
    if isinstance(metric, str):
        key = metric.lower()
        if key not in _METRIC_REGISTRY:
            raise ValueError("Metric must be in registry %s"
                             % sorted(_METRIC_REGISTRY))
        return _METRIC_REGISTRY[key](*args, **kwargs)
    raise TypeError("metric should be a str, an EvalMetric or a list of "
                    "them (CustomMetric is not ported)")


class CompositeEvalMetric(EvalMetric):
    """Fans updates out to several child metrics."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError("Metric index {} is out of range 0 and {}"
                             .format(index, len(self.metrics)))
        return self.metrics[index]

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = OrderedDict((k, v) for k, v in labels.items()
                                 if k in self.label_names)
        if self.output_names is not None:
            preds = OrderedDict((k, v) for k, v in preds.items()
                                if k in self.output_names)
        for m in self.metrics:
            m.update_dict(labels, preds)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        for m in self.metrics:
            m.reset_local()

    @staticmethod
    def _concat(readings):
        names, values = [], []
        for name, value in readings:
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)

    def get(self):
        return self._concat(m.get() for m in self.metrics)

    def get_global(self):
        return self._concat(m.get_global() for m in self.metrics)


class Accuracy(EvalMetric):
    """Fraction of predictions equal to the label; class scores become
    their argmax over ``axis``."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _measure(self, label, pred):
        if pred.shape != label.shape:
            pred = pred.argmax(axis=self.axis)
        lab = label.astype("int64").ravel()
        prd = pred.astype("int64").ravel()
        check_label_shapes(lab, prd, shape=True)
        return float((lab == prd).sum()), lab.size


class TopKAccuracy(EvalMetric):
    """Fraction of labels among the ``top_k`` highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        if top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more than 1")
        self.top_k = top_k
        self.name = "{}_{}".format(self.name, top_k)

    def _measure(self, label, pred):
        if pred.ndim > 2:
            raise ValueError("Predictions should be no more than 2 dims")
        lab = label.astype("int64").ravel()
        if pred.ndim == 1:
            return float((pred.astype("int64") == lab).sum()), lab.size
        k = min(self.top_k, pred.shape[1])
        top = numpy.argpartition(pred.astype("float32"), -k, axis=1)[:, -k:]
        return float((top == lab[:, None]).any(axis=1).sum()), pred.shape[0]


class CrossEntropy(EvalMetric):
    """Mean of ``-log(p[label] + eps)`` over rows of class probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _measure(self, label, pred):
        lab = label.astype("int64").ravel()
        if lab.shape[0] != pred.shape[0]:
            raise ValueError("label rows %d != pred rows %d"
                             % (lab.shape[0], pred.shape[0]))
        picked = pred[numpy.arange(lab.shape[0]), lab]
        return float(-numpy.log(picked + self.eps).sum()), lab.shape[0]


class Loss(EvalMetric):
    """Mean of a loss output (the labels are ignored)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        for pred in preds if isinstance(preds, (list, tuple)) else [preds]:
            arr = _asnumpy(pred)
            self._accumulate(float(arr.sum()), arr.size)


register(CompositeEvalMetric)
register(Accuracy, "acc")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(CrossEntropy, "ce")
register(Loss)
