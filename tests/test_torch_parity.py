"""Shared helpers of the port parity tests (no tests of its own): a narrow
ResNetV1 built in both packages on the same numpy weights."""
import numpy as onp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

# one bottleneck per stage, widths 8..128, 10 classes
NARROW = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def port_narrow():
    """The port's narrow ResNetV1, parameters allocated on the CPU."""
    net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize(ctx=mxt.cpu())
    net(mxt.nd.zeros((1, 3, 32, 32), ctx=mxt.cpu()))
    return net


def random_weights(seed):
    """numpy weights for the narrow net by structural name; BN statistics
    kept plausible so that normalization is not the identity."""
    shapes = {k: p.shape
              for k, p in port_narrow()._collect_params_with_prefix().items()}
    rng = onp.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(("running_var", "gamma")):
            out[name] = rng.uniform(0.5, 1.5, shape).astype("float32")
        elif name.endswith(("running_mean", "beta", "bias")):
            out[name] = rng.uniform(-0.2, 0.2, shape).astype("float32")
        else:
            fan_in = int(onp.prod(shape[1:]))
            out[name] = (rng.randn(*shape) / onp.sqrt(fan_in)) \
                .astype("float32")
    return out


def jax_narrow(weights):
    """The JAX package's narrow ResNetV1 holding ``weights``, hybridized
    (one XLA program compiles faster than the op-by-op first forward)."""
    net = jresnet.ResNetV1(jresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[name]))
    net.hybridize()
    return net
