"""Estimator event handlers: the lifecycle mixins and the stopping,
metric, validation, logging, checkpoint and early-stopping handlers.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/event_handler.py``.
``CheckpointHandler`` writes the net's ``save_parameters`` file and the
trainer's ``save_states`` file, which the JAX package reads too.
"""
from __future__ import annotations

import logging
import os
import time
import warnings

import numpy as onp

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


# the estimator dispatches on isinstance: each event has its own mixin
# with one overridable no-op hook

class TrainBegin:
    """Mixin: handler wants the train_begin event."""

    def train_begin(self, estimator, *args, **kwargs):
        return None


class TrainEnd:
    """Mixin: handler wants the train_end event."""

    def train_end(self, estimator, *args, **kwargs):
        return None


class EpochBegin:
    """Mixin: handler wants the epoch_begin event."""

    def epoch_begin(self, estimator, *args, **kwargs):
        return None


class EpochEnd:
    """Mixin: handler wants the epoch_end event."""

    def epoch_end(self, estimator, *args, **kwargs):
        return None


class BatchBegin:
    """Mixin: handler wants the batch_begin event."""

    def batch_begin(self, estimator, *args, **kwargs):
        return None


class BatchEnd:
    """Mixin: handler wants the batch_end event."""

    def batch_end(self, estimator, *args, **kwargs):
        return None


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch epochs or max_batch batches."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch, self.max_batch = max_epoch, max_batch
        self.stop_training = False
        self._restart_counters()

    def _restart_counters(self):
        self.current_batch = self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        # budgets live on the estimator and may have changed since __init__
        self.max_epoch, self.max_batch = (estimator.max_epoch,
                                          estimator.max_batch)
        self._restart_counters()

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        self.stop_training |= self.current_batch == self.max_batch

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        self.stop_training |= self.current_epoch == self.max_epoch


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics at epoch start, update them per batch."""

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []
        self.priority = -onp.inf  # update before other handlers read

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        for metric in self.train_metrics:
            if metric.name and "loss" in metric.name:
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every N batches or epochs."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = self.current_epoch = 0

    def _tick(self, count, period):
        if period and count % period == 0:
            self.eval_fn(val_data=self.val_data)
        return count

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch = self._tick(self.current_batch + 1,
                                        self.batch_period)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch = self._tick(self.current_epoch + 1,
                                        self.epoch_period)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log training progress."""

    LOG_PER_EPOCH = 1
    LOG_PER_BATCH = 2

    def __init__(self, file_name=None, file_location=None,
                 filemode="a", verbose=LOG_PER_EPOCH,
                 train_metrics=None, val_metrics=None):
        self.logger = logging.getLogger(__name__)
        self.logger.setLevel(logging.INFO)
        if file_name or file_location:
            file_name = file_name or "estimator_log"
            file_location = file_location or "./"
            self.logger.addHandler(logging.FileHandler(
                os.path.join(file_location, file_name), mode=filemode))
        if verbose not in (self.LOG_PER_EPOCH, self.LOG_PER_BATCH):
            raise ValueError("verbose must be LOG_PER_EPOCH or LOG_PER_BATCH")
        self.verbose = verbose
        self.train_metrics = train_metrics or []
        self.val_metrics = val_metrics or []
        self.batch_index = self.current_epoch = self.processed_samples = 0
        self.priority = onp.inf  # log after metric updates

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        trainer = estimator.trainer
        optimizer = type(trainer._optimizer).__name__
        lr = trainer.learning_rate
        self.logger.info("Training begin: using optimizer %s with "
                         "learning rate %.4f", optimizer, lr)
        if estimator.max_epoch:
            self.logger.info("Train for %d epochs.", estimator.max_epoch)
        else:
            self.logger.info("Train for %d batches.", estimator.max_batch)

    def train_end(self, estimator, *args, **kwargs):
        train_time = time.time() - self.train_start
        msg = "Train finished using total %ds with %d epochs. " % (
            train_time, self.current_epoch)
        for m in self.train_metrics + self.val_metrics:
            name, value = m.get()
            msg += "%s: %.4f, " % (name, value)
        self.logger.info(msg.rstrip(", "))

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        epoch_time = time.time() - self.epoch_start
        msg = "[Epoch %d] finished in %.3fs: " % (self.current_epoch,
                                                  epoch_time)
        for m in self.train_metrics + self.val_metrics:
            name, value = m.get()
            msg += "%s: %.4f, " % (name, value)
        self.logger.info(msg.rstrip(", "))
        self.current_epoch += 1
        self.batch_index = 0

    @property
    def _per_batch(self):
        return self.verbose == self.LOG_PER_BATCH

    def batch_begin(self, estimator, *args, **kwargs):
        if self._per_batch:
            self.batch_start = time.time()

    def batch_end(self, estimator, *args, **kwargs):
        if self._per_batch:
            batch_time = time.time() - self.batch_start
            msg = "[Epoch %d][Batch %d]" % (self.current_epoch,
                                            self.batch_index)
            self.processed_samples += kwargs.get("batch", [None])[0].shape[0] \
                if kwargs.get("batch") else 0
            msg += " time/batch: %.3fs " % batch_time
            for m in self.train_metrics:
                name, value = m.get()
                msg += "%s: %.4f, " % (name, value)
            self.logger.info(msg.rstrip(", "))
        self.batch_index += 1


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save model params (+ trainer states) periodically; keep best by a
    monitored metric."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.verbose = verbose
        self.save_best = save_best
        if self.save_best and monitor is None:
            raise ValueError("save_best requires a monitor metric")
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.saved_checkpoints = []
        self.current_batch = 0
        self.current_epoch = 0
        if mode not in ("auto", "min", "max"):
            warnings.warn("mode %s unknown; falling back to auto" % mode)
            mode = "auto"
        if mode == "min":
            self.monitor_op = onp.less
        elif mode == "max":
            self.monitor_op = onp.greater
        else:
            if monitor is not None and "acc" in (monitor.get()[0] or ""):
                self.monitor_op = onp.greater
            else:
                self.monitor_op = onp.less
        self.best = onp.inf if self.monitor_op == onp.less else -onp.inf

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save_checkpoint(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save_checkpoint(estimator)

    def _save_checkpoint(self, estimator):
        prefix = os.path.join(self.model_dir, self.model_prefix)
        path = "%s-epoch%dbatch%d.params" % (prefix, self.current_epoch,
                                             self.current_batch)
        estimator.net.save_parameters(path)
        estimator.trainer.save_states(path.replace(".params", ".states"))
        self.saved_checkpoints.append(path)
        if self.verbose > 0:
            logging.info("saved checkpoint to %s", path)
        while len(self.saved_checkpoints) > self.max_checkpoints:
            old = self.saved_checkpoints.pop(0)
            for f in (old, old.replace(".params", ".states")):
                if os.path.exists(f):
                    os.remove(f)
        if self.save_best:
            _, value = self.monitor.get()
            if self.monitor_op(value, self.best):
                self.best = value
                estimator.net.save_parameters(prefix + "-best.params")


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when a monitored metric stops improving."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        if mode not in ("auto", "min", "max"):
            warnings.warn("mode %s unknown; falling back to auto" % mode)
            mode = "auto"
        if mode == "min":
            self.monitor_op = onp.less
        elif mode == "max":
            self.monitor_op = onp.greater
        else:
            if "acc" in (monitor.get()[0] or ""):
                self.monitor_op = onp.greater
            else:
                self.monitor_op = onp.less
        self._maximizing = self.monitor_op is onp.greater
        if not self._maximizing:
            self.min_delta = -self.min_delta

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = self.stopped_epoch = self.current_epoch = 0
        self.stop_training = False
        worst = -onp.inf if self._maximizing else onp.inf
        self.best = self.baseline if self.baseline is not None else worst

    def epoch_end(self, estimator, *args, **kwargs):
        _, value = self.monitor.get()
        if value is None or (isinstance(value, float)
                             and onp.isnan(value)):
            self.current_epoch += 1
            return
        improved = self.monitor_op(value - self.min_delta, self.best)
        self.wait = 0 if improved else self.wait + 1
        if improved:
            self.best = value
        elif self.wait >= self.patience:
            self.stopped_epoch = self.current_epoch
            self.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.info("Epoch %d: early stopping due to no improvement "
                         "in %s", self.stopped_epoch,
                         self.monitor.get()[0])
