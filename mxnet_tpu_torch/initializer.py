"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``Uniform`` (the
``Block.initialize`` default), ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``Zero``, ``One``, ``Constant`` and
``LSTMBias``, dispatched on the parameter's name suffix as in MXNet
(``*weight`` gets the initializer's draw, ``*bias``/``*beta``/
``*running_mean`` zeros, ``*gamma``/``*running_var`` ones).  An
initializer fills an NDArray in place; random draws come from the port's
generator of that array's device (``mx.random``), so they follow
``mx.random.seed``.  Parameters are initialized on the host and then
placed, so a seed gives the same weights on every device.  ``Mixed``
picks an initializer by a parameter's name and ``Load`` copies given
arrays.  ``dumps()`` gives the JSON form ``[name, kwargs]`` that
``create`` reads.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, Type

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "register", "Zero", "One", "Constant",
           "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu",
           "Bilinear", "LSTMBias", "Load", "Mixed", "create"]

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
    """Base initializer: ``init(desc, arr)`` fills ``arr`` by name suffix.
    The keyword arguments a subclass passes here are what ``dumps``
    writes."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[lower-case class name, kwargs]`` as JSON, which ``create``
        reads back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        """Fill ``arr`` by the pattern of its name; an ``InitDesc`` whose
        attributes carry ``__init__`` (a variable made with ``init=``)
        takes that initializer instead."""
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        if init:
            create(init)._init_weight(desc, arr)
            return
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
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg") \
                or name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
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

    def _uniform(self, arr, scale, shape=None):
        out = torch.empty(shape or arr.shape, dtype=torch.float32,
                          device=arr._data.device)
        return out.uniform_(-scale, scale, generator=_gen(arr))

    def _normal(self, arr, sigma, shape=None):
        out = torch.empty(shape or arr.shape, dtype=torch.float32,
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
        super().__init__(value=value)
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
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._fill(arr, self._uniform(arr, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._fill(arr, self._normal(arr, self.sigma))


@register
class Orthogonal(Initializer):
    """An orthogonal basis (Saxe et al. 2013): the singular vectors of a
    uniform (-1, 1) or normal draw of (out, prod(rest)), times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(onp.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        shape = (nout, nin)
        if self.rand_type == "uniform":
            tmp = self._uniform(arr, 1.0, shape)
        else:
            tmp = self._normal(arr, 1.0, shape)
        u, _, v = torch.linalg.svd(tmp.cpu().double(), full_matrices=False)
        q = u if tuple(u.shape) == shape else v
        self._fill(arr, (self.scale * q).float())


@register
class Xavier(Initializer):
    """Glorot initialization with a uniform or gaussian draw."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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
class MSRAPrelu(Xavier):
    """He initialization for a PReLU of ``slope``: a gaussian Xavier of
    magnitude ``2 / (1 + slope²)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two dims, each filter
    the same (an ``UpSampling``/``Deconvolution`` weight)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        i = onp.arange(int(onp.prod(shape)))
        f = onp.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = (1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c))
        self._fill(arr, torch.from_numpy(weight.astype(onp.float32)))


@register
class LSTMBias(Initializer):
    """A zero bias with the forget gate's quarter (gates [i, f, g, o]) set
    to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        self._fill(arr, b)


class Load:
    """Values from ``param`` (name to array; ``arg:``/``aux:`` prefixes
    dropped) for the names it holds, ``default_init`` for the others."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src = onp.asarray(src.asnumpy() if hasattr(src, "asnumpy")
                              else src)
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, src.shape))
            Initializer._fill(arr, torch.from_numpy(src.copy()))
        else:
            if self.default_init is None:
                raise ValueError("Cannot Initialize parameter: %s" % name)
            self.default_init(name, arr)


class Mixed:
    """The initializer of the first regular expression of ``patterns``
    that matches a parameter's name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have the same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern"
                         % name)


def create(init, **kwargs):
    """An initializer from an instance, a callable, a name or the JSON of
    ``dumps``."""
    if isinstance(init, Initializer) or callable(init):
        return init
    if isinstance(init, str):
        if init.strip().startswith("["):
            name, kw = json.loads(init)
            return _INIT_REGISTRY[name.lower()](**kw)
        klass = _INIT_REGISTRY.get(init.strip().lower())
        if klass is None:
            raise MXNetError("unknown initializer %r" % init)
        return klass(**kwargs)
    raise MXNetError("cannot create initializer from %r" % (init,))
