"""``mx.sym.linalg``: the short spellings of the ``linalg_*`` ops, the
names of ``mx.nd.linalg``, as ``mxnet_tpu/symbol/linalg.py``."""
from __future__ import annotations

from ..ndarray.linalg import __all__  # noqa: F401  (same surface)


def __getattr__(name):
    if name in __all__:
        from .. import symbol as _sym
        return getattr(_sym, "linalg_" + name)
    raise AttributeError("module 'symbol.linalg' has no attribute %r"
                         % name)
