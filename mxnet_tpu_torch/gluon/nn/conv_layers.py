"""Convolution and pooling Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``Conv1D/2D/3D``,
the transposed ``Conv*DTranspose`` (``Deconvolution``, weight (in,
out / groups, *k)), ``Max/Avg/GlobalMax/GlobalAvgPool1D/2D/3D`` over the
shared ``_Conv``/``_Pooling`` bases (channels first, as in the JAX
package) and ``ReflectionPad2D``.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    if len(t) != n:
        raise ValueError("expected %d values, got %r" % (n, v))
    return t


class _Conv(HybridBlock):
    """Shared convolution layer: ``op_name`` ``Convolution`` (weight
    (out, in / groups, *k)) or ``Deconvolution`` (weight (in, out /
    groups, *k), ``adj`` the output padding), optional bias and
    activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            wshape = self._weight_shape(in_channels)
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

    def _weight_shape(self, in_channels):
        g, k = self._kwargs["num_group"], tuple(self._kwargs["kernel"])
        if self._op_name == "Convolution":
            return (self._channels, in_channels // g) + k
        return (in_channels, self._channels // g) + k

    def infer_shape(self, x, *args):
        self.weight._finish_deferred_init(self._weight_shape(x.shape[1]))
        if self.bias is not None:
            self.bias._finish_deferred_init((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, shape[1] if shape[1] else None,
            shape[0], self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 1),
                         _to_tuple(strides, 1), _to_tuple(padding, 1),
                         _to_tuple(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


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


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, 3),
                         _to_tuple(strides, 3), _to_tuple(padding, 3),
                         _to_tuple(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    """A transposed convolution of ``ndim`` spatial dims."""

    def __init__(self, ndim, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, activation,
                 use_bias, weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        super().__init__(channels, _to_tuple(kernel_size, ndim),
                         _to_tuple(strides, ndim), _to_tuple(padding, ndim),
                         _to_tuple(dilation, ndim), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_to_tuple(output_padding, ndim), **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, layout, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


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


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "max", layout, **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", layout, **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "max", layout,
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "avg", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", layout, **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", layout,
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two dims: ``padding`` an int (each
    side) or ``pad``'s 8-tuple."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
