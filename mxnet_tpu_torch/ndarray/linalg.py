"""``mx.nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``): the
short names of the registered ``linalg_*`` operators."""
from __future__ import annotations

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "sumlogdiag", "extractdiag", "makediag", "inverse", "det",
           "slogdet"]


def __getattr__(name):
    if name in __all__:
        from .. import ndarray as _nd
        return getattr(_nd, "linalg_" + name)
    raise AttributeError("module 'ndarray.linalg' has no attribute %r"
                         % name)
