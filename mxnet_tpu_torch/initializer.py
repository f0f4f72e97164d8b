"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``Uniform`` (the
``Block.initialize`` default), ``Normal``, ``Xavier``, ``Zero``, ``One``,
``Constant`` and ``LSTMBias``, dispatched on the parameter's name suffix
as in MXNet (``*weight`` gets the initializer's draw, ``*bias``/``*beta``/
``*running_mean`` zeros, ``*gamma``/``*running_var`` ones).  An
initializer fills an NDArray in place; random draws come from the port's
generator of that array's device (``mx.random``), so they follow
``mx.random.seed``.  Parameters are initialized on the host and then
placed, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Dict, Type

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "register", "Zero", "One", "Constant",
           "Uniform", "Normal", "Xavier", "LSTMBias", "create"]

_INIT_REGISTRY: Dict[str, Type["Initializer"]] = {}


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Parameter name plus attributes, passed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _gen(arr) -> torch.Generator:
    return _random.generator(arr._data.device)


class Initializer:
    """Base initializer: ``init(desc, arr)`` fills ``arr`` by name suffix."""

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _fill(arr, value: torch.Tensor):
        arr._data = value.to(device=arr._data.device,
                             dtype=arr._data.dtype).reshape(arr.shape)

    def _init_zero(self, name, arr):
        self._fill(arr, torch.zeros(arr.shape))

    def _init_one(self, name, arr):
        self._fill(arr, torch.ones(arr.shape))

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_gamma(self, name, arr):
        self._init_one(name, arr)

    def _init_beta(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is limited to \"weight\", \"bias\", \"gamma\" and \"beta\"."
            % name)

    def _uniform(self, arr, scale):
        out = torch.empty(arr.shape, dtype=torch.float32,
                          device=arr._data.device)
        return out.uniform_(-scale, scale, generator=_gen(arr))

    def _normal(self, arr, sigma):
        out = torch.empty(arr.shape, dtype=torch.float32,
                          device=arr._data.device)
        return out.normal_(0.0, sigma, generator=_gen(arr))


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0):
        self.value = value

    def _init_weight(self, name, arr):
        v = self.value
        if hasattr(v, "astorch"):
            v = v.astorch()
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(onp.array(v))
        self._fill(arr, v.broadcast_to(arr.shape))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        self._fill(arr, self._uniform(arr, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._fill(arr, self._normal(arr, self.sigma))


@register
class Xavier(Initializer):
    """Glorot initialization with a uniform or gaussian draw."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = float(onp.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._fill(arr, self._uniform(arr, scale))
        elif self.rnd_type == "gaussian":
            self._fill(arr, self._normal(arr, scale))
        else:
            raise ValueError("Unknown random type")


@register
class LSTMBias(Initializer):
    """A zero bias with the forget gate's quarter (gates [i, f, g, o]) set
    to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        self._fill(arr, b)


def create(init, **kwargs):
    """An initializer from an instance, a callable or a name."""
    if isinstance(init, Initializer) or callable(init):
        return init
    if isinstance(init, str):
        klass = _INIT_REGISTRY.get(init.strip().lower())
        if klass is None:
            raise MXNetError("unknown initializer %r" % init)
        return klass(**kwargs)
    raise MXNetError("cannot create initializer from %r" % (init,))
