"""Training callbacks: ``Speedometer``, ``ProgressBar``,
``do_checkpoint``, ``module_checkpoint``, ``log_train_metric`` and
``LogValidationMetricsCallback``.

Counterpart of the same callbacks in ``mxnet_tpu/callback.py``: each is
called at the end of a batch (or an epoch) with a ``BatchEndParam`` and
logs through ``logging``.  ``Speedometer`` logs the samples per second of
the last ``frequent`` batches (and the metric, when one is given).
``do_checkpoint`` and ``module_checkpoint`` are epoch-end callbacks
writing ``model.save_checkpoint``'s files every ``period`` epochs.  The
telemetry suffix of the JAX package's line and its ``attach`` wait with
the rest of ``telemetry.py`` (ROADMAP.md, queue 1, item 8).
"""
from __future__ import annotations

import logging
import math
import time
from collections import namedtuple

from . import telemetry

__all__ = ["BatchEndParam", "Speedometer", "ProgressBar", "do_checkpoint",
           "module_checkpoint", "log_train_metric",
           "LogValidationMetricsCallback"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


class Speedometer:
    """Logs ``Epoch[e] Batch [a-b]\\tSpeed: s samples/sec`` every
    ``frequent`` batches; ``speed`` holds the last value logged."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        elapsed = time.time() - self.tic
        self.speed = self.frequent * self.batch_size / elapsed \
            if elapsed > 0 else float("inf")
        msg = "Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec"
        args = [param.epoch, count - self.frequent, count, self.speed]
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset_local()
            msg += "\t%s=%f" * len(name_value)
            args += sum(name_value, ())
        logging.info(msg, *args)
        self.tic = time.time()


class ProgressBar:
    """Logs an ASCII bar of ``nbatch`` out of ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


def do_checkpoint(prefix, period=1):
    """An epoch-end callback ``(epoch, sym, arg, aux)`` saving
    ``prefix-symbol.json`` and ``prefix-%04d.params`` (epoch + 1) every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
            telemetry.event("checkpoint", prefix, epoch=iter_no + 1)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback checkpointing the Module ``mod`` every
    ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
            telemetry.event("checkpoint", prefix, epoch=iter_no + 1)
    return _callback


def log_train_metric(period, auto_reset=False):
    """A batch-end callback logging the metric every ``period`` batches
    (``auto_reset``: then clearing its window)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class LogValidationMetricsCallback:
    """An epoch-end callback logging each validation metric."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
