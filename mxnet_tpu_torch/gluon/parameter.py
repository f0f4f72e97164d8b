"""Gluon Parameter and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``: a Parameter holds one
NDArray on one context, with deferred initialization (a 0 in the shape is
filled in by the layer at its first forward), ``data()``, ``set_data()``
and ``initialize()``.  Values are initialized on the host from the port's
generator and then placed on the parameter's context.  A parameter whose
``grad_req`` is not ``'null'`` is an autograd variable with a gradient
buffer (``grad()``) that each ``backward`` writes (``'write'``) or adds to
(``'add'``); ``set_data`` updates the value in place, so the variable
stays one.  ``lr_mult`` and ``wd_mult`` scale the optimizer's rates;
``cast`` changes the dtype and ``reset_ctx`` the device.  ``Constant`` is a
parameter without a gradient that holds a given value, and
``ParameterDict.save``/``load`` write and read the JAX package's file
format, keyed by the full (prefixed) names.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as onp
import torch

from .. import autograd, initializer
from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context
from ..ndarray import NDArray, array
from ..ndarray.ndarray import _wrap

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's shape is not known yet."""


class Parameter:
    """A trainable array with lazy allocation.

    ``shape`` may hold 0 for a dimension unknown until the first forward;
    ``dtype`` is a numpy dtype or a name ("float32", "bfloat16")."""

    def __init__(self, name, grad_req="write", shape=None, dtype=onp.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self.name = name
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._grad_req = None
        self.grad_req = grad_req
        self._deferred_init = ()

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                     self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of 'write', 'add', or "
                             "'null', but got %r" % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                autograd.mark_variables([self._data], [None], "null")
                self._data._data.requires_grad_(False)
        elif self._data is not None:
            self._init_grad()

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape) if new_shape is not None else None
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or not all(
                s1 in (0, s2) for s1, s2 in zip(self._shape, new_shape)):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s for "
                "Parameter %s" % (str(new_shape), str(self._shape), self.name))
        self._shape = new_shape

    def initialize(self, init=None, ctx=None,
                   default_init=initializer.Uniform(), force_reinit=False):
        """Allocate and fill on ``ctx`` (default: the current context).
        Unknown dims defer the allocation to the first forward."""
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        ctx.torch_device          # fail now, not at the first forward
        init = init if init is not None else self.init
        if self._shape is None or any(s <= 0 for s in self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self._shape)))
        self._init_impl(init, ctx, default_init)

    def _init_impl(self, init, ctx, default_init):
        self._deferred_init = ()
        # fresh weights are ordinary tensors even when the deferred init
        # runs inside a serving forward's inference_mode
        with torch.inference_mode(False):
            host = _wrap(torch.zeros(self._shape, dtype=torch.float32))
            desc = initializer.InitDesc(self.name)
            if init is not None:
                fn = initializer.create(init)
                if isinstance(fn, initializer.Initializer):
                    fn._init_weight(desc, host)
                else:
                    fn(desc, host)
            else:
                initializer.create(default_init)(desc, host)
            self._data = _wrap(host._data.to(
                device=Context(ctx).torch_device,
                dtype=torch_dtype(self.dtype)))
            if self._grad_req != "null":
                self._init_grad()

    def _init_grad(self):
        """A zero gradient buffer beside the value, which becomes an
        autograd variable with this parameter's ``grad_req``."""
        self._grad = _wrap(torch.zeros_like(self._data._data.detach()))
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    def _finish_deferred_init(self, shape):
        """Complete a deferred init once the layer knows the full shape."""
        self.shape = shape
        if self._deferred_init:
            init, ctx, default_init = self._deferred_init
            self._init_impl(init, ctx, default_init)

    def data(self, ctx=None) -> NDArray:
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter '%s' has not been initialized yet because "
                    "initialization was deferred. Actual initialization "
                    "happens during the first forward pass." % self.name)
            raise RuntimeError(
                "Parameter '%s' has not been initialized. You should "
                "initialize parameters with Block.initialize()." % self.name)
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer; raises when ``grad_req`` is ``'null'``."""
        if self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to zeros (for ``grad_req='add'``)."""
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return [self._data.context]

    def set_data(self, data):
        """Replace the value (an NDArray, tensor or numpy array) in place,
        on the parameter's own context and dtype; an autograd variable stays
        one.  A deferred parameter takes its shape from ``data`` and is
        initialized with it."""
        if self._data is None:
            if not self._deferred_init:
                raise RuntimeError("Parameter '%s' has not been initialized"
                                   % self.name)
            self.shape = tuple(data.shape)
            _, ctx, default_init = self._deferred_init
            self._init_impl(initializer.Constant(data), ctx, default_init)
            return
        if tuple(data.shape) != tuple(self._shape):
            raise AssertionError(
                "Failed to update param '%s': shape %s does not match "
                "existing shape %s." % (self.name, tuple(data.shape),
                                        self._shape))
        if isinstance(data, NDArray):
            data = data.astorch()
        elif not isinstance(data, torch.Tensor):
            data = torch.from_numpy(onp.array(data))
        with torch.no_grad():
            self._data._data.copy_(data.detach())

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (the first of a list), where it is a
        variable again with a zero gradient; a deferred parameter will be
        allocated there."""
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        if self._data is not None:
            self._data = self._data.as_in_context(ctx)
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        """Change the dtype of the value and of the gradient buffer (the
        variable stays one); a parameter not allocated yet takes ``dtype``
        when it is."""
        self.dtype = dtype
        if self._data is None:
            return
        dt = torch_dtype(dtype)
        with torch.no_grad():
            self._data._data = self._data._data.detach().to(dt)
        if self._grad_req != "null":
            self._init_grad()

    def var(self):
        """This parameter as a Symbol variable (name, shape, dtype and
        initializer), for ``HybridBlock`` called on a Symbol."""
        from .. import symbol
        return symbol.var(self.name, shape=self.shape, dtype=self.dtype,
                          init=self.init)

    def _load_init(self, data, ctx=None):
        """Initialize from a loaded array (a checkpoint entry)."""
        if self._shape is not None and len(self._shape) == len(data.shape):
            self.shape = tuple(d if s == 0 else s
                               for s, d in zip(self._shape, data.shape))
        else:
            self._shape = tuple(data.shape)
        if self._data is not None:
            self.set_data(data)
        elif self._deferred_init:
            _, dctx, _ = self._deferred_init
            self._init_impl(initializer.Constant(data), ctx or dctx, None)
        else:
            self._init_impl(initializer.Constant(data),
                            ctx or current_context(), None)


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = array(value, ctx=cpu())
        self.value = value

        class _Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                self._fill(arr, value.astorch().detach().cpu())

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_Init(),
                         differentiable=False)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix and a shared
    fallback dict."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "%s(\n  %s\n)" % (
            self._prefix + " " if self._prefix else "",
            "\n  ".join(repr(v) for v in self._params.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create the parameter ``prefix + name``; an existing one
        must agree with the requested attributes."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None or v is None:
                if v is not None:
                    setattr(param, k, v)
                continue
            if k == "shape" and len(v) == len(existing):
                param.shape = tuple(a if a != 0 else b
                                    for a, b in zip(v, existing))
                continue
            if k == "dtype":
                if torch_dtype(existing) != torch_dtype(v):
                    raise AssertionError(
                        "Parameter '%s' already exists with dtype=%s, "
                        "conflicting with requested dtype=%s."
                        % (name, existing, v))
                continue
            if k in ("init", "grad_req", "lr_mult", "wd_mult") \
                    and existing != v:
                raise AssertionError(
                    "Parameter '%s' already exists with %s=%s, conflicting "
                    "with requested %s=%s." % (name, k, existing, k, v))
        return param

    def get_constant(self, name, value=None):
        """Get or create the constant ``prefix + name`` holding ``value``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'." % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise AssertionError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def initialize(self, init=initializer.Uniform(), ctx=None, verbose=False,
                   force_reinit=False):
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx``."""
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set one attribute (``grad_req``, ``lr_mult``, ``wd_mult``...) on
        every parameter."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's value under its name less
        ``strip_prefix``, in the JAX package's file format."""
        from ..ndarray.utils import save as nd_save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with it."
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a file of ``save`` (of either package), its names prefixed
        with ``restore_prefix``; arrays are read on the host and placed on
        each parameter's context (``ctx`` for those not yet allocated)."""
        from ..ndarray.utils import load as nd_load
        arg_dict = {restore_prefix + k: v
                    for k, v in nd_load(filename, ctx=cpu()).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(
                        "Parameter '%s' is missing in file '%s'"
                        % (name[len(restore_prefix):], filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in this ParameterDict"
                        % (name[len(restore_prefix):], filename))
                continue
            self[name]._load_init(value, ctx)
