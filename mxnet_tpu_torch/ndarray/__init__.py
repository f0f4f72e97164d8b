"""``mx.nd`` namespace: NDArray plus every registered op as a function.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: op names resolve
lazily against the op registry (PEP 562 ``__getattr__``), so ``F.<Op>``
inside a layer's ``hybrid_forward`` finds ``ops/nn.py``'s functions.
NDArray arguments are unwrapped to tensors, the op runs, and its outputs
are wrapped back.  ``training`` is filled in from autograd's thread-local
mode for ops that depend on it, and every op runs through
``autograd.call_op``: it records a graph only inside ``autograd.record()``.
Where AMP has installed a cast policy (``ops/registry.py``), the op's
floating NDArray inputs are first cast to the dtype it names, inside the
recorded call, as the JAX package's dispatch casts them.
"""
from __future__ import annotations

from .. import autograd as _ag
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import torch_dtype as _torch_dtype
from ..ops.registry import get_cast_policy, get_op, list_ops
from .ndarray import (  # noqa: F401
    NDArray, array, zeros, ones, arange, split, concat, stack, _wrap)
from .utils import save, load  # noqa: F401
from . import contrib  # noqa: F401

_FUNC_CACHE = {}


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _amp_casting(op, policy, args, kwargs):
    """``op.fn`` behind the cast the policy asks for, or None: the floating
    NDArray inputs (positional or keyword) whose dtype differs from the
    policy's target are cast to it, the rest pass as they are."""
    pos = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
    kws = [k for k, v in kwargs.items() if isinstance(v, NDArray)]
    if not pos and not kws:
        return None
    static = {k: v for k, v in kwargs.items() if k not in kws}
    target = policy(op.name, [_dtype_name(args[i]._data) for i in pos]
                    + [_dtype_name(kwargs[k]._data) for k in kws], static)
    if target is None:
        return None
    dt = _torch_dtype(target)

    def cast(t):
        return t.to(dt) if t.is_floating_point() and t.dtype != dt else t

    def fn(*a, **kw):
        a = list(a)
        for i in pos:
            a[i] = cast(a[i])
        for k in kws:
            kw[k] = cast(kw[k])
        return op.fn(*a, **kw)
    return fn


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
        policy = get_cast_policy()
        fn = op.fn if policy is None else \
            _amp_casting(op, policy, args, kwargs) or op.fn
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        kwargs = {k: v._data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        res = _ag.call_op(fn, *args, **kwargs)
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
