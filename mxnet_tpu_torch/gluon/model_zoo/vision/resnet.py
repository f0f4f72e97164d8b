"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``).

He et al., "Deep Residual Learning" (v1) and "Identity Mappings" (v2,
pre-activation).  The same constructors, layer order and auto-names as
the JAX package, so structural parameter names
(``features.5.0.body.0.weight``) and checkpoints agree between the two.
Every v1 residual unit ends in ``nn.BatchNormAddReLU``, which runs the
hand-written BN -> add -> ReLU epilogue kernel on the card: 16 launches per
ResNet-50 forward, 50 per ResNet-152 forward.  A v2 unit adds its
residual after its last convolution and has no such tail.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ..model_store import get_model_file

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class _ResidualV1(HybridBlock):
    """Runs ``body`` with its last layer (``BatchNormAddReLU``) taking the
    (possibly downsampled) input as the residual."""

    def hybrid_forward(self, F, x):
        residual = x
        body = list(self.body)
        for layer in body[:-1]:
            x = layer(x)
        if self.downsample:
            residual = self.downsample(residual)
        return body[-1](x, residual)

    def _add_downsample(self, downsample, channels, stride, in_channels):
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None


class BasicBlockV1(_ResidualV1):
    """Two 3x3 convolutions and a shortcut (ResNet-18/34 unit)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNormAddReLU())
        self._add_downsample(downsample, channels, stride, in_channels)


class BottleneckV1(_ResidualV1):
    """1x1-3x3-1x1 bottleneck (ResNet-50/101/152 unit)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNormAddReLU())
        self._add_downsample(downsample, channels, stride, in_channels)


class BasicBlockV2(HybridBlock):
    """Pre-activation basic unit (v2): BN-ReLU-conv3x3 twice, the shortcut
    (a strided 1x1 convolution where the shape changes) taken after the
    first BN-ReLU."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(
                channels, 1, stride, use_bias=False, in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck unit (v2): BN-ReLU before each of the
    1x1, 3x3 (strided) and 1x1 convolutions."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(
                channels, 1, stride, use_bias=False, in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels=0):
    """Stage ``stage_index``: ``layers`` units of ``block``, the first
    one strided (and downsampling where the width changes)."""
    layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return layer


class ResNetV1(HybridBlock):
    """ResNet v1 trunk and classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet v2 trunk and classifier: a BatchNorm without scale or shift
    on the input, the stem, the pre-activation stages, then BN-ReLU,
    global pooling and the dense layer."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count per stage plus the stem")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (block kind, units per stage, channels per stage)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

_NETS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                        "bottle_neck": BottleneckV1}),
         2: (ResNetV2, {"basic_block": BasicBlockV2,
                        "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Build a ResNet v1 or v2 of depth ``num_layers``.
    ``pretrained=True`` loads ``resnet<depth>_v<version>.params`` from the
    local model store, which raises when the file is absent (none ships
    with the repository)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in _NETS:
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    block_type, layers, channels = resnet_spec[num_layers]
    net_class, blocks = _NETS[version]
    net = net_class(blocks[block_type], layers, channels, **kwargs)
    if pretrained:
        kw = {} if root is None else {"root": root}
        net.load_parameters(get_model_file(
            "resnet%d_v%d" % (num_layers, version), **kw), ctx=ctx)
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
