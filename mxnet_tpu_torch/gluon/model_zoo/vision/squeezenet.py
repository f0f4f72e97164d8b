"""SqueezeNet 1.0/1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``).

Iandola et al.: fire modules (squeeze 1x1, then expand 1x1 and 3x3
concatenated).  Its max pools take the ``full`` (ceil) convention.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ..model_store import get_model_file

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _Fire(HybridBlock):
    """Fire module: squeeze then concat of 1x1/3x3 expands — expressed as a
    block (not the reference's HybridConcurrent) so the concat is explicit."""

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = _make_fire_conv(squeeze_channels, 1)
        self.expand1x1 = _make_fire_conv(expand1x1_channels, 1)
        self.expand3x3 = _make_fire_conv(expand3x3_channels, 3, 1)

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    r"""SqueezeNet (reference squeezenet.py SqueezeNet).

    Parameters
    ----------
    version : str — '1.0' or '1.1'.
    classes : int — number of output classes.
    """

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    """Build a SqueezeNet (reference squeezenet.py:113)."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        kw = {} if root is None else {"root": root}
        net.load_parameters(get_model_file(
            "squeezenet%s" % version, **kw), ctx=ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
