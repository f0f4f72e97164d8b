"""Contrib samplers (counterpart of
``mxnet_tpu/gluon/contrib/data/sampler.py``; reference
``python/mxnet/gluon/contrib/data/sampler.py``)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Sample i, i+interval, i+2*interval, ... for each start offset i
    (reference contrib/data/sampler.py IntervalSampler)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, \
            "interval %d must not be larger than length %d" % (
                interval, length)
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        return self._length
