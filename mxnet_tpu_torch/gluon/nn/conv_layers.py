"""Convolution and pooling Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` for the ResNet
serving path: ``Conv2D``, ``MaxPool2D`` and ``GlobalAvgPool2D`` over the
shared ``_Conv``/``_Pooling`` bases (NCHW, as in the JAX package).  The
1-D/3-D, transposed and average-pooling layers come with later slices.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    if len(t) != n:
        raise ValueError("expected %d values, got %r" % (n, v))
    return t


class _Conv(HybridBlock):
    """Shared convolution layer (weight OIHW, optional bias and
    activation)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        with self.name_scope():
            wshape = (channels, in_channels // groups) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        g = self._kwargs["num_group"]
        self.weight._finish_deferred_init(
            (self._channels, x.shape[1] // g) + tuple(self._kwargs["kernel"]))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, shape[1] if shape[1] else None,
            shape[0], self._kwargs["kernel"], self._kwargs["stride"])


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 2),
                         _to_tuple(strides, 2), _to_tuple(padding, 2),
                         _to_tuple(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Shared pooling layer."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s, ceil_mode=%s)" % (
            self.__class__.__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"],
            self._kwargs["pooling_convention"] == "full")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", layout, **kwargs)
