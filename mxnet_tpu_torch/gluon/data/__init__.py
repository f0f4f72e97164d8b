"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, the DataLoader (in this process, in worker processes or on
threads) and the vision datasets and transforms."""
from .dataset import Dataset, ArrayDataset, SimpleDataset  # noqa: F401
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from . import vision  # noqa: F401

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn", "vision"]
