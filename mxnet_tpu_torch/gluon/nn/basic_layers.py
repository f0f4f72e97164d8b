"""Basic Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``,
``HybridSequential``, ``Dense``, ``Activation``, ``Dropout``,
``BatchNorm``, ``BatchNormAddReLU``, ``InstanceNorm``, ``LayerNorm``,
``GroupNorm``, ``Embedding``, ``Flatten``, ``Lambda`` and
``HybridLambda``.  Each layer manages its parameters and deferred shapes
and calls the registered ops (``ops/nn.py``) through ``F``.
"""
from __future__ import annotations

import functools

import numpy as onp
import torch

from ... import autograd
from ...base import torch_dtype
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "BatchNormAddReLU", "InstanceNorm", "LayerNorm",
           "GroupNorm", "Flatten", "Lambda", "HybridLambda", "Activation"]


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialMixin, Block):
    """Stack of blocks run one after another."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """Stack of hybrid blocks run one after another."""


class Dense(HybridBlock):
    """Fully-connected layer ``y = act(x·Wᵀ + b)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._in_units = in_units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_units = int(onp.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, linear)" % (
            self.__class__.__name__, shape[1] if shape[1] else None, shape[0])


class Activation(HybridBlock):
    """Activation layer (``relu``, ``sigmoid``, ``tanh``, ...)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class Dropout(HybridBlock):
    """Inverted dropout: the identity outside training, a Bernoulli mask
    from the port's generator (``mx.random``) in training."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes, cudnn_off=True)
        return x

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


@functools.lru_cache(maxsize=None)
def _rounded(c, dtype):
    """The Python number ``c`` rounded to ``dtype`` (exact in fp32, so a
    product with it rounds once, as the JAX package's weak scalar does)."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics.  In training mode the
    op returns the batch statistics and this layer updates the moving
    averages."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self.in_channels = in_channels
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._finish_deferred_init((c,))

    def cast(self, dtype):
        """As ``Block.cast``, except that float16 keeps the four
        parameters in float32, as the JAX package's BatchNorm does: the
        moving statistics are then averaged in float32 and the folded
        scale and shift start from float32 values.  The cached graph is
        dropped (``HybridBlock.cast``)."""
        if torch_dtype(dtype) == torch.float16:
            dtype = "float32"
        super().cast(dtype)

    def _update_moving(self, running_mean, running_var, mean, var):
        """Moving averages from the (detached) batch statistics, outside
        any recorded graph, so no step's graph outlives its backward.  Each
        product takes the momentum rounded to its operand's dtype, as a
        Python scalar meets an array in the JAX package: the float16
        statistics of a float16 net are scaled by float16(1 - m), rounded
        to float16 and added to the float32 averages."""
        if autograd.is_training() and not self._kwargs["use_global_stats"]:
            m = self._momentum
            with torch.no_grad():
                for param, run, stat in ((self.running_mean, running_mean,
                                          mean),
                                         (self.running_var, running_var,
                                          var)):
                    r, b = run._data, stat._data.detach()
                    param.set_data(r * _rounded(m, r.dtype)
                                   + b * _rounded(1 - m, b.dtype))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, mean, var = F.BatchNorm(x, gamma, beta, running_mean,
                                     running_var, **self._kwargs)
        self._update_moving(running_mean, running_var, mean, var)
        return out

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return "BatchNorm(axis=%d, eps=%s, momentum=%s, in_channels=%s)" % (
            self._axis, self._kwargs["eps"], self._momentum, in_channels)


class BatchNormAddReLU(BatchNorm):
    """``relu(BatchNorm(x) + residual)``, the tail of every ResNet v1
    residual unit, through the fused epilogue kernel.  Same parameters and
    auto-naming alias as :class:`BatchNorm`, so parameter names and
    checkpoints match a plain BatchNorm in its place."""

    def _alias(self):
        return "batchnorm"

    def hybrid_forward(self, F, x, residual, gamma, beta, running_mean,
                       running_var):
        out, mean, var = F.BatchNormAddRelu(x, residual, gamma, beta,
                                            running_mean, running_var,
                                            **self._kwargs)
        self._update_moving(running_mean, running_var, mean, var)
        return out


class _AffineNorm(HybridBlock):
    """A normalization with a learned per-channel ``gamma`` and ``beta``
    (deferred to the size of ``x.shape[self._axis]``)."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))


class InstanceNorm(_AffineNorm):
    """Normalization over the spatial dims of each sample and channel
    (``axis``, 1 by default, is the channel axis)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon) \
            .swapaxes(1, self._axis)


class LayerNorm(_AffineNorm):
    """Layer normalization over ``axis`` with a learned scale and shift."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix=prefix,
                         params=params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class GroupNorm(_AffineNorm):
    """Normalization over each of ``num_groups`` channel groups (axis 1)
    and the spatial dims."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Index → vector lookup."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), init=weight_initializer,
            dtype=dtype, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "Embedding(%d -> %d, %s)" % (
            self._input_dim, self._output_dim, self._kwargs["dtype"])


class Flatten(HybridBlock):
    """Flatten to ``(batch, -1)``."""

    def hybrid_forward(self, F, x):
        return x.reshape((0, -1))

    def __repr__(self):
        return self.__class__.__name__


class Lambda(Block):
    """A function as a Block: ``function`` a callable or the name of an
    ``mx.nd`` op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            if not hasattr(nd, function):
                raise ValueError("Function name %s is not found in ndarray."
                                 % function)
            self._func_impl = getattr(nd, function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: %s of type %s"
                             % (function, type(function)))

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """A function as a HybridBlock: ``function(F, x, *args)``, or the name
    of an op called as ``F.<name>(x, *args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: %s of type %s"
                             % (function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
