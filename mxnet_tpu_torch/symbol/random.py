"""``mx.sym.random``: the draws of ``mx.nd.random`` as graph nodes, through
the same name-to-op table, as ``mxnet_tpu/symbol/random.py``."""
from __future__ import annotations

from ..ndarray.random import _FORWARD

__all__ = sorted(_FORWARD)


def __getattr__(name):
    if name in _FORWARD:
        from .. import symbol as _sym
        return getattr(_sym, _FORWARD[name])
    raise AttributeError("module 'symbol.random' has no attribute %r"
                         % name)
