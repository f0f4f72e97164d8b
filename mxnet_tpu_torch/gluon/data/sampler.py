"""Samplers: ``SequentialSampler``, ``RandomSampler`` and ``BatchSampler``.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py``.  ``RandomSampler``
draws its permutation from the port's host ``torch.Generator``
(``mx.random.seed`` sets it) where the JAX package uses numpy's global
generator.
"""
from __future__ import annotations

import torch

from ... import random as _random

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """Abstract sampler over indices."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A new permutation of ``range(length)`` at every pass."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(torch.randperm(
            self._length, generator=_random.generator("cpu")).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Batches of a sampler's indices; the last partial batch is kept,
    discarded or rolled over into the next pass."""

    _POLICIES = ("keep", "discard", "rollover")

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in self._POLICIES:
            raise ValueError("last_batch must be one of 'keep', 'discard', or "
                             "'rollover', but got %s" % last_batch)
        self._sampler = sampler
        self._batch_size, self._last_batch = batch_size, last_batch
        self._prev = []

    def __iter__(self):
        pending = self._prev
        self._prev = []
        for idx in self._sampler:
            pending.append(idx)
            if len(pending) >= self._batch_size:
                yield pending[:self._batch_size]
                pending = pending[self._batch_size:]
        if not pending:
            return
        if self._last_batch == "keep":
            yield pending
        elif self._last_batch == "rollover":
            self._prev = pending

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
