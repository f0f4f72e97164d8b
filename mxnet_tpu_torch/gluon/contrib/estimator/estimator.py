"""Gluon Estimator: ``fit`` and ``evaluate`` over a net, a loss, metrics
and a trainer, with event handlers.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/estimator.py``.  Each
training batch is split over the contexts (``split_and_load``), run
forward and through the loss under ``autograd.record()``, differentiated
with ``backward`` and stepped with ``Trainer.step(batch_size)``, as a
hand-written loop would; the handlers run between batches.  The defaults
are the JAX package's: ``SoftmaxCrossEntropyLoss``, ``Accuracy`` and Adam
at a learning rate of 1e-3.  The default context is the current one
(``gpu(0)`` unless a ``with mx.cpu():`` scope is open): the Estimator
never picks the CPU because no card is found.
"""
from __future__ import annotations

import copy
import warnings

from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler, LoggingHandler)
from .... import autograd
from .... import context as ctx_mod
from ....metric import EvalMetric, Loss as LossMetric, Accuracy
from ...loss import Loss as GluonLoss, SoftmaxCrossEntropyLoss
from ...trainer import Trainer
from ...utils import split_and_load

__all__ = ["Estimator"]


class Estimator:
    """Fit or evaluate ``net`` with ``loss``, ``metrics`` and ``trainer``
    on ``context`` (a Context or a list of them)."""

    def __init__(self, net, loss=None, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = self._check_loss(loss)
        self.train_metrics = self._check_metrics(metrics)
        self.context = self._check_context(context)
        self._initialize(initializer)
        self.trainer = self._check_trainer(trainer)
        self.max_epoch = None
        self.max_batch = None

    @staticmethod
    def _check_loss(loss):
        if loss is None:
            return SoftmaxCrossEntropyLoss()
        if not isinstance(loss, GluonLoss):
            raise ValueError("loss must be a gluon.loss.Loss instance")
        return loss

    @staticmethod
    def _check_metrics(metrics):
        if metrics is None:
            return [Accuracy()]
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        if not all(isinstance(m, EvalMetric) for m in metrics):
            raise ValueError("metrics must be EvalMetric instances")
        return list(metrics)

    @staticmethod
    def _check_context(context):
        if context is None:
            context = [ctx_mod.current_context()]
        if isinstance(context, ctx_mod.Context):
            context = [context]
        return context

    def _initialize(self, initializer):
        params = self.net.collect_params()
        uninitialized = any(p._data is None for p in params.values())
        if uninitialized:
            self.net.initialize(initializer, ctx=self.context)
        elif initializer is not None:
            warnings.warn("network already initialized; ignoring the "
                          "initializer")

    def _check_trainer(self, trainer):
        if trainer is None:
            trainer = Trainer(self.net.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        elif not isinstance(trainer, Trainer):
            raise ValueError("trainer must be a gluon.Trainer")
        return trainer

    # -- evaluation ------------------------------------------------------
    def evaluate(self, val_data, val_metrics=None, batch_axis=0):
        """The metrics (reset first) over the batches of ``val_data``;
        returns them."""
        val_metrics = self._check_metrics(val_metrics) \
            if val_metrics is not None else self.val_metrics
        for metric in val_metrics:
            metric.reset()
        for batch in val_data:
            data, label = self._unpack_batch(batch, batch_axis)
            pred = [self.net(x) for x in data]
            loss = [self.loss(y_hat, y) for y_hat, y in zip(pred, label)]
            for metric in val_metrics:
                if isinstance(metric, LossMetric) or (
                        metric.name and "loss" in metric.name):
                    metric.update(0, loss)
                else:
                    metric.update(label, pred)
        return val_metrics

    def _unpack_batch(self, batch, batch_axis):
        data, label = batch[0], batch[1]
        data = split_and_load(data, self.context, batch_axis=batch_axis)
        label = split_and_load(label, self.context, batch_axis=batch_axis)
        return data, label

    # -- training --------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        """Train for ``epochs`` epochs or ``batches`` batches (exactly one
        of them), validating on ``val_data`` after each epoch."""
        if not (epochs is None) != (batches is None):
            raise ValueError("specify exactly one of epochs / batches")
        self.max_epoch = epochs
        self.max_batch = batches
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        for vm in self.val_metrics:
            vm.name = "validation " + (vm.name or "")
        event_handlers = self._prepare_default_handlers(
            val_data, event_handlers)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize_handlers(event_handlers)
        estimator_ref = self

        for handler in train_begin:
            handler.train_begin(estimator_ref)

        stop = False
        while not stop:
            for handler in epoch_begin:
                handler.epoch_begin(estimator_ref)
            for batch in train_data:
                data, label = self._unpack_batch(batch, batch_axis)
                batch_size = batch[0].shape[batch_axis]
                for handler in batch_begin:
                    handler.batch_begin(estimator_ref, batch=batch)
                with autograd.record():
                    pred = [self.net(x) for x in data]
                    loss = [self.loss(y_hat, y)
                            for y_hat, y in zip(pred, label)]
                for l in loss:
                    l.backward()
                self.trainer.step(batch_size)
                for handler in batch_end:
                    handler.batch_end(estimator_ref, batch=batch,
                                      pred=pred, label=label, loss=loss)
                if any(getattr(h, "stop_training", False)
                       for h in event_handlers):
                    stop = True
                    break
            else:
                for handler in epoch_end:
                    handler.epoch_end(estimator_ref)
                if any(getattr(h, "stop_training", False)
                       for h in event_handlers):
                    stop = True
                continue
            break

        for handler in train_end:
            handler.train_end(estimator_ref)

    def _prepare_default_handlers(self, val_data, event_handlers):
        event_handlers = list(event_handlers or [])
        added = []
        if not any(isinstance(h, StoppingHandler) for h in event_handlers):
            event_handlers.append(StoppingHandler(self.max_epoch,
                                                  self.max_batch))
        if not any(isinstance(h, MetricHandler) for h in event_handlers):
            event_handlers.append(MetricHandler(self.train_metrics))
            added.append("MetricHandler")
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in event_handlers):
            event_handlers.append(ValidationHandler(
                val_data=val_data,
                eval_fn=lambda val_data: self.evaluate(val_data)))
            added.append("ValidationHandler")
        if not any(isinstance(h, LoggingHandler) for h in event_handlers):
            event_handlers.append(LoggingHandler(
                train_metrics=self.train_metrics,
                val_metrics=self.val_metrics))
            added.append("LoggingHandler")
        if added:
            warnings.warn("No handler specified for %s; default handlers "
                          "were added" % ", ".join(added))
        event_handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return event_handlers

    @staticmethod
    def _categorize_handlers(event_handlers):
        return ([h for h in event_handlers if isinstance(h, TrainBegin)],
                [h for h in event_handlers if isinstance(h, EpochBegin)],
                [h for h in event_handlers if isinstance(h, BatchBegin)],
                [h for h in event_handlers if isinstance(h, BatchEnd)],
                [h for h in event_handlers if isinstance(h, EpochEnd)],
                [h for h in event_handlers if isinstance(h, TrainEnd)])
