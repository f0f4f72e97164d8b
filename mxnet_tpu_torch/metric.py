"""Evaluation metrics on the host.

Counterpart of ``mxnet_tpu/metric.py``, with every metric of it: the
math runs in numpy on the host, on predictions copied off the device
(``asnumpy``), so the numbers are the JAX package's.  Every update feeds
two (sum, count) cells: the window (cleared by ``reset_local``, read by
``get``) and the run total (cleared by ``reset``, read by
``get_global``).  F1 and MCC keep a two-class confusion matrix (``micro``)
or average each batch's score (``macro``); Perplexity exponentiates the
pooled mean log-loss.  ``register(klass)`` and ``alias(*names)`` fill the
registry that ``create`` reads; ``register`` also takes aliases after the
class (``register(Accuracy, "acc")``).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "create", "register", "alias", "np",
           "check_label_shapes"]


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Validate that labels and predictions pair up.

    With ``shape=False`` compares counts (list lengths); with ``shape=True``
    compares array shapes.  ``wrap=True`` additionally listifies bare
    arrays so callers can iterate uniformly.
    """
    lhs = labels.shape if shape else len(labels)
    rhs = preds.shape if shape else len(preds)
    if lhs != rhs:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(lhs, rhs))
    if wrap:
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
    return labels, preds


def _asnumpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


class EvalMetric:
    """Base metric.

    Subclasses either override ``update`` wholesale or (via ``_PairMetric``)
    implement ``_measure``.  All accumulation goes through ``_accumulate``,
    which feeds two (sum, count) cells: the *window* (cleared by
    ``reset_local``, read by ``get``) and the *run total* (cleared only by
    ``reset``, read by ``get_global``).
    """

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._init_kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    # -- accumulation ---------------------------------------------------
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

    # the raw accumulators of MXNet's metrics: views of the window cell
    @property
    def sum_metric(self):
        return self._win[0]

    @sum_metric.setter
    def sum_metric(self, v):
        self._win[0] = v

    @property
    def num_inst(self):
        return self._win[1]

    @num_inst.setter
    def num_inst(self, v):
        self._win[1] = v

    # -- reading --------------------------------------------------------
    def _finalize(self, mean):
        """Hook: map the accumulated mean to the reported value."""
        return mean

    def _read(self, cell):
        total, count = cell
        if count == 0:
            return (self.name, float("nan"))
        return (self.name, self._finalize(total / count))

    def get(self):
        return self._read(self._win)

    def get_global(self):
        return self._read(self._run)

    def _pairs(self, reading):
        name, value = reading
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))

    def get_name_value(self):
        return self._pairs(self.get())

    def get_global_name_value(self):
        return self._pairs(self.get_global())

    # -- updating -------------------------------------------------------
    def update(self, labels, preds):
        raise NotImplementedError()

    def update_dict(self, label, pred):
        """Update from {name: array} dicts, selecting this metric's
        output/label names when set."""
        if self.output_names is None:
            outs = list(pred.values())
        else:
            outs = [pred[n] for n in self.output_names]
        if self.label_names is None:
            labs = list(label.values())
        else:
            labs = [label[n] for n in self.label_names]
        self.update(labs, outs)

    def get_config(self):
        config = dict(self._init_kwargs)
        config.update(metric=self.__class__.__name__, name=self.name,
                      output_names=self.output_names,
                      label_names=self.label_names)
        return config


class _PairMetric(EvalMetric):
    """Template for metrics that consume (label, pred) array pairs."""

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for lab, prd in zip(labels, preds):
            value, count = self._measure(_asnumpy(lab), _asnumpy(prd))
            self._accumulate(value, count)

    def _measure(self, label, pred):
        raise NotImplementedError()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_METRIC_REGISTRY = {}


def register(klass, *aliases):
    """Enter ``klass`` under its lower-cased name, and under each alias
    given after it; returns the class (a decorator)."""
    if not isinstance(klass, type):
        raise TypeError("register takes a class")
    for n in (klass.__name__,) + aliases:
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def alias(*names):
    """A decorator entering the class under ``names`` and its own name."""
    def _register(klass):
        return register(klass, *names)
    return _register


def create(metric, *args, **kwargs):
    """A metric from a name (with its constructor's arguments), a
    callable ``feval`` (a ``CustomMetric``), an instance, or a list of
    those (a ``CompositeEvalMetric``)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
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
            raise ValueError(
                "Metric must be either callable or in registry %s"
                % sorted(_METRIC_REGISTRY))
        return _METRIC_REGISTRY[key](*args, **kwargs)
    raise TypeError("metric should be callable, str, or EvalMetric instance")


@register
class CompositeEvalMetric(EvalMetric):
    """Fan updates out to several child metrics."""

    def __init__(self, metrics=None, name="composite",
                 output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError(
                "Metric index {} is out of range 0 and {}".format(
                    index, len(self.metrics)))
        return self.metrics[index]

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = OrderedDict(
                (k, v) for k, v in labels.items() if k in self.label_names)
        if self.output_names is not None:
            preds = OrderedDict(
                (k, v) for k, v in preds.items() if k in self.output_names)
        for m in self.metrics:
            m.update_dict(labels, preds)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        for m in getattr(self, "metrics", []):
            m.reset_local()

    def _concat(self, readings):
        names, values = [], []
        for name, value in readings:
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)

    def get(self):
        return self._concat(m.get() for m in self.metrics)

    def get_global(self):
        return self._concat(m.get_global() for m in self.metrics)

    def get_config(self):
        config = super().get_config()
        config["metrics"] = [m.get_config() for m in self.metrics]
        return config


# ---------------------------------------------------------------------------
# classification metrics
# ---------------------------------------------------------------------------

def _class_predictions(label, pred, axis=-1):
    """Collapse class scores to predicted indices when shapes differ."""
    if pred.shape != label.shape:
        pred = pred.argmax(axis=axis)
    return label.astype("int64").ravel(), pred.astype("int64").ravel()


@alias("acc")
class Accuracy(_PairMetric):
    """Fraction of exactly-matched predictions."""

    def __init__(self, axis=1, name="accuracy",
                 output_names=None, label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _measure(self, label, pred):
        lab, prd = _class_predictions(label, pred, self.axis)
        check_label_shapes(lab, prd, shape=True)
        return float((lab == prd).sum()), lab.size


@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(_PairMetric):
    """Label-in-top-k rate."""

    def __init__(self, top_k=1, name="top_k_accuracy",
                 output_names=None, label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        assert top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.top_k = top_k
        self.name = "{}_{}".format(self.name, top_k)

    def _measure(self, label, pred):
        assert pred.ndim <= 2, "Predictions should be no more than 2 dims"
        lab = label.astype("int64").ravel()
        if pred.ndim == 1:
            hits = (pred.astype("int64") == lab).sum()
            return float(hits), lab.size
        k = min(self.top_k, pred.shape[1])
        top = numpy.argpartition(pred.astype("float32"), -k, axis=1)[:, -k:]
        hits = (top == lab[:, None]).any(axis=1).sum()
        return float(hits), pred.shape[0]


class _ConfusionCounts:
    """2-class confusion matrix built with one bincount per batch."""

    __slots__ = ("tn", "fp", "fn", "tp")

    def __init__(self):
        self.clear()

    def clear(self):
        self.tn = self.fp = self.fn = self.tp = 0

    def add_batch(self, label, pred):
        lab, prd = _class_predictions(label, pred, axis=1)
        check_label_shapes(lab, prd, shape=True)
        if numpy.unique(lab).size > 2:
            raise ValueError(
                "binary classification metric got >2 label classes")
        cells = numpy.bincount(2 * (lab != 0) + (prd != 0), minlength=4)
        self.tn += int(cells[0])
        self.fp += int(cells[1])
        self.fn += int(cells[2])
        self.tp += int(cells[3])

    @property
    def total(self):
        return self.tn + self.fp + self.fn + self.tp

    @property
    def precision(self):
        marked = self.tp + self.fp
        return self.tp / marked if marked else 0.0

    @property
    def recall(self):
        actual = self.tp + self.fn
        return self.tp / actual if actual else 0.0

    @property
    def fscore(self):
        pr = self.precision + self.recall
        return 2.0 * self.precision * self.recall / pr if pr else 0.0

    @property
    def matthewscc(self):
        if not self.total:
            return 0.0
        sides = [self.tp + self.fp, self.tp + self.fn,
                 self.tn + self.fp, self.tn + self.fn]
        denom = 1.0
        for s in sides:
            if s:
                denom *= float(s)
        return (self.tp * self.tn - self.fp * self.fn) / math.sqrt(denom)


class _ConfusionMetric(EvalMetric):
    """Shared machinery for F1/MCC: macro averages per-batch scores, micro
    keeps a running confusion matrix and scores it at read time."""

    _stat = None  # property name on _ConfusionCounts

    def __init__(self, name, average="macro", output_names=None,
                 label_names=None):
        self._average = average
        self._win_counts = _ConfusionCounts()
        self._run_counts = _ConfusionCounts()
        super().__init__(name, average=average, output_names=output_names,
                         label_names=label_names)

    def reset(self):
        super().reset()
        if hasattr(self, "_win_counts"):
            self._win_counts.clear()
            self._run_counts.clear()

    def reset_local(self):
        super().reset_local()
        self._win_counts.clear()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for lab, prd in zip(labels, preds):
            lab, prd = _asnumpy(lab), _asnumpy(prd)
            if self._average == "macro":
                batch = _ConfusionCounts()
                batch.add_batch(lab, prd)
                self._accumulate(getattr(batch, self._stat), 1)
            else:
                self._win_counts.add_batch(lab, prd)
                self._run_counts.add_batch(lab, prd)

    def _read(self, cell):
        if self._average == "macro":
            return super()._read(cell)
        counts = self._win_counts if cell is self._win else self._run_counts
        if not counts.total:
            return (self.name, float("nan"))
        return (self.name, getattr(counts, self._stat))


@register
class F1(_ConfusionMetric):
    """Binary F1."""

    _stat = "fscore"

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, average=average, output_names=output_names,
                         label_names=label_names)


@register
class MCC(_ConfusionMetric):
    """Matthews correlation coefficient."""

    _stat = "matthewscc"

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, average=average, output_names=output_names,
                         label_names=label_names)


@register
class Perplexity(_PairMetric):
    """exp of the mean per-token log-loss.

    Accumulates raw log-loss and token counts so multi-batch evaluation is
    exact — ``get`` exponentiates the pooled mean, never averages
    per-batch perplexities.
    """

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def _measure(self, label, pred):
        classes = pred.shape[-1]
        if label.size * classes != pred.size:
            raise ValueError("shape mismatch: %s vs. %s"
                             % (label.shape, pred.shape))
        lab = label.astype("int64").ravel()
        probs = pred.reshape(-1, classes)[numpy.arange(lab.size), lab]
        keep = numpy.ones_like(probs, dtype=bool)
        if self.ignore_label is not None:
            keep = lab != self.ignore_label
        logloss = -numpy.log(
            numpy.maximum(probs[keep], 1e-10)).sum()
        return float(logloss), int(keep.sum())

    def _finalize(self, mean):
        return math.exp(mean)


# ---------------------------------------------------------------------------
# regression metrics
# ---------------------------------------------------------------------------

class _RegressionMetric(_PairMetric):
    """Per-batch scalar over the elementwise error (count = 1/batch)."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _measure(self, label, pred):
        err = label.astype("float64") - pred.astype("float64").reshape(
            label.shape)
        return self._score(err), 1

    def _score(self, err):
        raise NotImplementedError()


@register
class MAE(_RegressionMetric):
    """Mean absolute error."""

    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def _score(self, err):
        return float(numpy.abs(err).mean())


@register
class MSE(_RegressionMetric):
    """Mean squared error."""

    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def _score(self, err):
        return float(numpy.square(err).mean())


@register
class RMSE(_RegressionMetric):
    """Root mean squared error."""

    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def _score(self, err):
        return float(math.sqrt(numpy.square(err).mean()))


class _TrueClassLogLoss(_PairMetric):
    """Shared by CrossEntropy/NLL: -log p[true class], averaged per row."""

    def __init__(self, eps, name, **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps

    def _measure(self, label, pred):
        lab = label.astype("int64").ravel()
        if lab.shape[0] != pred.shape[0]:
            raise ValueError("label rows %d != pred rows %d"
                             % (lab.shape[0], pred.shape[0]))
        picked = pred[numpy.arange(lab.shape[0]), lab]
        return float(-numpy.log(picked + self.eps).sum()), lab.shape[0]


@alias("ce")
class CrossEntropy(_TrueClassLogLoss):
    """Cross entropy over softmax outputs."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(eps, name, **kwargs)


@alias("nll_loss")
class NegativeLogLikelihood(_TrueClassLogLoss):
    """NLL over probability outputs."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps, name, **kwargs)


@alias("pearsonr")
class PearsonCorrelation(_PairMetric):
    """Pearson correlation per batch."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _measure(self, label, pred):
        check_label_shapes(label, pred, shape=True)
        return float(numpy.corrcoef(pred.ravel(), label.ravel())[0, 1]), 1


@register
class Loss(EvalMetric):
    """Mean of a (pre-computed) loss output."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        for pred in preds if isinstance(preds, (list, tuple)) else [preds]:
            arr = _asnumpy(pred)
            self._accumulate(float(arr.sum()), arr.size)


@register
class Torch(Loss):
    """``Loss`` under MXNet's name for a Torch module's loss output."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """``Loss`` under MXNet's name for a Caffe module's loss output."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, which returns
    a value or a (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        for prd, lab in zip(preds, labels):
            result = self._feval(_asnumpy(lab), _asnumpy(prd))
            if isinstance(result, tuple):
                self._accumulate(*result)
            else:
                self._accumulate(result, 1)

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a bare numpy feval as a CustomMetric."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)
