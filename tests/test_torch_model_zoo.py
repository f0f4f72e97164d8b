"""Port parity: the vision model zoo of ``mxnet_tpu_torch`` against the
JAX package's, every family, with the JAX net's weights carried into the
port's net by ``load_jax_params`` (structural names; nothing missing or
left over) and random moving statistics, then the same seeded input
through both in predict mode (and one family in training mode).

The nets are narrow where a constructor allows it (``ResNetV2`` and
``VGG`` with small widths, ``DenseNet(8, 4, [1, 1, 1, 1])``, MobileNet
v1 and v2 at 0.25) and at full width where it does not (AlexNet,
SqueezeNet, Inception v3 at 299 x 299), on small inputs where the net
allows them.  The JAX nets' shapes come from ``materialize_params``
(abstract tracing) and their forwards are hybridized, one XLA program
each, or the test would spend its time compiling op by op.

Tolerance: the logits within 2e-5 of the largest JAX logit in magnitude
(float32; the two packages sum convolutions in other orders).  Every net
is built under an explicit prefix, so no auto-naming counter moves.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.utils import materialize_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.utils import load_jax_params

RTOL = 2e-5


def _carry(jnet, tnet, shape, seed, train=False):
    """Initialize ``jnet`` (Xavier, random BatchNorm statistics and
    affine), copy it into ``tnet`` and return both outputs on one input."""
    rs = onp.random.RandomState(seed)
    x = rs.uniform(-1, 1, shape).astype("float32")
    jnet.initialize(mx.init.Xavier())
    materialize_params(jnet, mx.nd.array(x))
    arrays = {}
    for name, p in jnet._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if name.endswith(("running_mean", "beta")):
            a = rs.uniform(-0.2, 0.2, a.shape).astype("float32")
        elif name.endswith(("running_var", "gamma")):
            a = rs.uniform(0.5, 1.5, a.shape).astype("float32")
        p.set_data(mx.nd.array(a))
        arrays[name] = a
    jnet.hybridize()
    with mxt.cpu():
        tnet.initialize()
        load_jax_params(tnet, arrays)
        if train:
            with mx.autograd.record(), mxt.autograd.record():
                return (tnet(mxt.nd.array(x)).asnumpy(),
                        jnet(mx.nd.array(x)).asnumpy())
        with mx.autograd.predict_mode(), mxt.autograd.predict_mode():
            return (tnet(mxt.nd.array(x)).asnumpy(),
                    jnet(mx.nd.array(x)).asnumpy())


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(onp.abs(got - want).max())
    scale = float(onp.abs(want).max())
    assert onp.isfinite(got).all() and err <= RTOL * scale, \
        "%s: max err %.3g > %.3g" % (what, err, RTOL * scale)


# (id, constructor name, args, kwargs, input shape)
FAMILIES = [
    ("resnet_v2_bottleneck", "ResNetV2", ("BottleneckV2", [1, 2, 1, 1],
                                          [8, 16, 32, 64, 128]),
     {"classes": 10}, (2, 3, 32, 32)),
    ("resnet_v2_basic_thumbnail", "ResNetV2", ("BasicBlockV2", [1, 1, 1, 1],
                                               [8, 8, 16, 32, 64]),
     {"classes": 10, "thumbnail": True}, (2, 3, 16, 16)),
    ("vgg", "VGG", ([1, 1, 2, 1, 1], [4, 8, 8, 16, 16]), {"classes": 10},
     (1, 3, 32, 32)),
    ("vgg_bn", "VGG", ([1, 1, 1, 2, 1], [4, 8, 8, 16, 16]),
     {"classes": 10, "batch_norm": True}, (1, 3, 32, 32)),
    ("alexnet", "AlexNet", (), {"classes": 10}, (1, 3, 67, 67)),
    ("squeezenet1.0", "SqueezeNet", ("1.0",), {"classes": 10},
     (1, 3, 64, 64)),
    ("squeezenet1.1", "SqueezeNet", ("1.1",), {"classes": 10},
     (1, 3, 64, 64)),
    ("densenet", "DenseNet", (8, 4, [1, 1, 1, 1]), {"classes": 10},
     (1, 3, 224, 224)),
    ("mobilenet0.25", "MobileNet", (0.25,), {"classes": 10},
     (1, 3, 32, 32)),
    ("mobilenetv2_0.25", "MobileNetV2", (0.25,), {"classes": 10},
     (1, 3, 32, 32)),
    ("inceptionv3", "Inception3", (), {}, (1, 3, 299, 299)),
]


def _build(pkg, ctor, args, kwargs, prefix):
    args = [getattr(pkg, a) if isinstance(a, str) and a.endswith("V2")
            else a for a in args]
    return getattr(pkg, ctor)(*args, prefix=prefix, **kwargs)


@pytest.mark.parametrize("family", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_forward_matches_jax(family):
    fid, ctor, args, kwargs, shape = family
    prefix = "zoo_%s_" % fid.replace(".", "_")
    got, want = _carry(_build(jvision, ctor, args, kwargs, prefix),
                       _build(tvision, ctor, args, kwargs, prefix),
                       shape, seed=len(fid))
    _close(got, want, fid)


def test_resnet_v2_training_forward_matches_jax():
    """Training mode: every BatchNorm normalizes by its batch's
    statistics."""
    args = ("BottleneckV2", [1, 1, 1, 1], [8, 16, 32, 64, 128])
    got, want = _carry(
        _build(jvision, "ResNetV2", args, {"classes": 10}, "zootrain_"),
        _build(tvision, "ResNetV2", args, {"classes": 10}, "zootrain_"),
        (4, 3, 32, 32), seed=3, train=True)
    _close(got, want, "resnet v2 training forward")


def _names():
    """The names of the JAX package's table, from its error message."""
    with pytest.raises(ValueError) as info:
        jvision.get_model("no-such-net")
    return info.value.args[0].split("\n\t")[1:]


def test_get_model_table_matches_jax():
    names = _names()
    assert len(names) == 34
    with pytest.raises(ValueError) as info:
        tvision.get_model("no-such-net")
    assert info.value.args[0] == "Model %s is not supported. Available " \
        "options are\n\t%s" % ("no-such-net", "\n\t".join(names))


@pytest.mark.parametrize("name", [
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
    "mobilenet0.75", "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
    "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25"])
def test_get_model_builds_the_same_net(name):
    """Full width, not initialized: the same structural parameter names,
    in order, and the same shapes (0 where deferred) as the JAX
    package's net of that name."""
    prefix = "zooname_%s_" % name.replace(".", "_")
    jp = jvision.get_model(name, prefix=prefix)._collect_params_with_prefix()
    tp = tvision.get_model(name, prefix=prefix)._collect_params_with_prefix()
    assert list(tp) == list(jp)
    assert [tuple(p.shape) for p in tp.values()] == \
        [tuple(p.shape) for p in jp.values()]


def test_pretrained_reads_the_local_store_only(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    for name in ("vgg11", "squeezenet1.1", "mobilenetv2_0.25"):
        with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
            tvision.get_model(name, pretrained=True,
                              prefix="zoopre_%s_" % name.replace(".", "_"))
