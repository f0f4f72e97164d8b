"""Data iterators (counterpart of ``mxnet_tpu/io``)."""
from .io import DataDesc, DataBatch, DataIter, NDArrayIter  # noqa: F401

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]
