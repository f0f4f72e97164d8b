"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers and a DataLoader that batches in the calling process."""
from .dataset import Dataset, ArrayDataset, SimpleDataset  # noqa: F401
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn"]
