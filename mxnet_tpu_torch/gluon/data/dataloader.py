"""DataLoader that batches in the calling process.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` with
``num_workers=0``: samples are read in the sampler's order and stacked by
``default_batchify_fn`` into NDArrays on the current context.  The worker
processes and their shared-memory batches come with a later slice.
"""
from __future__ import annotations

import numpy as onp

from ...base import MXNetError
from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch; tuple samples give a list of batches."""
    if isinstance(data[0], NDArray):
        return array(onp.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return array(onp.asarray(data))


class DataLoader:
    """Batches of a Dataset, from ``batch_size`` with ``shuffle`` or a
    ``sampler``, or from a ``batch_sampler``."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        if num_workers:
            raise MXNetError("DataLoader worker processes are not ported: "
                             "pass num_workers=0")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for indices in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in indices])

    def __len__(self):
        return len(self._batch_sampler)
