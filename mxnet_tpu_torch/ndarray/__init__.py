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
recorded call, as the JAX package's dispatch casts them.  An op flagged
``needs_rng`` gets the generator of its output's device
(``random.generator``, so ``generator_scope`` and a CUDA graph's
registered generators hold), where the JAX package's dispatch hands it a
key from ``next_key()``.  ``ctx=`` places an op's output (the current
context when an op has no array input), and ``out=`` receives it.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .. import random as _random
from ..base import torch_dtype as _torch_dtype
from ..context import Context, current_context
from ..ops.registry import get_cast_policy, get_op, list_ops
from .ndarray import (  # noqa: F401
    NDArray, array, empty, zeros, ones, full, arange, linspace, eye, split,
    concat, stack, add_n, waitall, from_numpy, _wrap)
from .utils import save, load, save_dict, load_dict  # noqa: F401
from . import contrib  # noqa: F401
from . import random  # noqa: F401
from . import linalg  # noqa: F401

_FUNC_CACHE = {}


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _amp_casting(name, base, policy, args, kwargs):
    """``base`` behind the cast the policy asks for, or None: the floating
    NDArray inputs (positional or keyword) whose dtype differs from the
    policy's target are cast to it, the rest pass as they are."""
    pos = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
    kws = [k for k, v in kwargs.items() if isinstance(v, NDArray)]
    if not pos and not kws:
        return None
    static = {k: v for k, v in kwargs.items() if k not in kws}
    target = policy(name, [_dtype_name(args[i]._data) for i in pos]
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
        return base(*a, **kw)
    return fn


def _context(ctx):
    """A ``ctx=`` argument as a Context (``"gpu(0)"`` spellings too)."""
    if isinstance(ctx, str):
        kind, _, dev = ctx.partition("(")
        return Context(kind, int(dev.rstrip(")")) if dev else 0)
    return ctx


def _device_of(ctx, args, kwargs):
    """Where an op's output goes: ``ctx``, else its first NDArray input's
    device, else the current context's."""
    if ctx is not None:
        return ctx.torch_device
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a._data.device
    return current_context().torch_device


def _make_op_func(op):
    """A callable for a registered op: NDArray positional/keyword
    arguments become tensors, everything else is a static attribute.
    ``ctx=`` places the output (a sampler draws there, from that device's
    generator); ``out=`` receives the result as ``a[:] = result`` would."""
    cached = _FUNC_CACHE.get(op.name)
    if cached is not None:
        return cached

    def func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = _context(kwargs.pop("ctx", None))
        if op.needs_training and "training" not in kwargs:
            kwargs["training"] = _ag.is_training()
        base = op.fn
        if op.needs_rng:
            base = functools.partial(
                op.fn, _random.generator(_device_of(ctx, args, kwargs)))
        policy = get_cast_policy()
        fn = base if policy is None else \
            _amp_casting(op.name, base, policy, args, kwargs) or base
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        kwargs = {k: v._data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        res = _ag.call_op(fn, *args, **kwargs)
        many = isinstance(res, (tuple, list))
        res = list(res) if many else [res]
        if ctx is not None:
            dev = ctx.torch_device
            res = [r if r.device == dev else r.to(dev) for r in res]
        res = [_wrap(r) for r in res]
        if out is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            for o, r in zip(outs, res):
                o._inplace(r)
            return out
        return res if many else res[0]

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
