"""Data iterators (counterpart of ``mxnet_tpu/io``)."""
from .io import (  # noqa: F401
    DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter, PrefetchingIter,
    CSVIter, MNISTIter, LibSVMIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "LibSVMIter"]
