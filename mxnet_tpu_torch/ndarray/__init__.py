"""``mx.nd`` namespace: NDArray plus every registered op as a function.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: op names resolve
lazily against the op registry (PEP 562 ``__getattr__``), so ``F.<Op>``
inside a layer's ``hybrid_forward`` finds ``ops/nn.py``'s functions.
NDArray arguments are unwrapped to tensors, the op runs, and its outputs
are wrapped back.  ``training`` is filled in from autograd's thread-local
mode for ops that depend on it, and every op runs through
``autograd.call_op``: it records a graph only inside ``autograd.record()``.
"""
from __future__ import annotations

from .. import autograd as _ag
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops.registry import get_op, list_ops
from .ndarray import (  # noqa: F401
    NDArray, array, zeros, ones, arange, split, concat, stack, _wrap)
from .utils import save, load  # noqa: F401
from . import contrib  # noqa: F401

_FUNC_CACHE = {}


def _make_op_func(op):
    """A callable for a registered op: NDArray positional/keyword
    arguments become tensors, everything else is a static attribute."""
    cached = _FUNC_CACHE.get(op.name)
    if cached is not None:
        return cached

    def func(*args, **kwargs):
        kwargs.pop("name", None)
        if op.needs_training and "training" not in kwargs:
            kwargs["training"] = _ag.is_training()
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        kwargs = {k: v._data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        res = _ag.call_op(op.fn, *args, **kwargs)
        if isinstance(res, (tuple, list)):
            return [_wrap(r) for r in res]
        return _wrap(res)

    func.__name__ = op.name
    func.__doc__ = op.doc
    _FUNC_CACHE[op.name] = func
    return func


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("module 'ndarray' has no attribute %r" % name)
    return _make_op_func(op)


def __dir__():
    return sorted(set(list(globals().keys()) + list_ops()))
