"""Training callbacks: ``Speedometer``.

Counterpart of ``Speedometer`` in ``mxnet_tpu/callback.py``: called at the
end of every batch with a ``BatchEndParam``, it logs the samples per
second of the last ``frequent`` batches (and the metric, when one is
given).  The telemetry suffix of the JAX package's line and the other
callbacks come with later slices.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

__all__ = ["BatchEndParam", "Speedometer"]

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
