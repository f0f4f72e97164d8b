"""Port parity: ResNet v1 of ``mxnet_tpu_torch`` against the JAX package's,
on weights carried over from the JAX net.

A narrow ResNetV1 (one bottleneck per stage, widths 8..128, 10 classes)
at 2x3x32x32: the eval logits agree within rel 1e-4 (float32 on both
sides; convolutions sum in another order, through 16 layers), whether
the weights arrive through ``load_jax_params`` or through a
``save_parameters`` file of the JAX package.  The structural names and
shapes of ``resnet50_v1`` agree between the packages without running it.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.gluon.utils import load_jax_params
from test_torch_parity import NARROW, jax_narrow, random_weights



@pytest.fixture(scope="module")
def jax_net_and_input():
    jnet = jax_narrow(random_weights(0))
    x = onp.random.RandomState(1).uniform(-1, 1, (2, 3, 32, 32)) \
        .astype("float32")
    with mx.autograd.predict_mode():
        want = jnet(mx.nd.array(x)).asnumpy()
    return jnet, x, want


def _port_logits(net, x):
    with torch.inference_mode():
        return net(mxt.nd.array(x, ctx=mxt.cpu())).asnumpy()


def test_logits_match_jax_via_load_jax_params(jax_net_and_input):
    jnet, x, want = jax_net_and_input
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize(ctx=mxt.cpu())
    load_jax_params(net, arrays)
    got = _port_logits(net, x)
    assert got.shape == (2, 10)
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # no transposes: every array landed as it was
    for k, p in net._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), arrays[k])


def test_logits_match_jax_via_saved_file(jax_net_and_input, tmp_path):
    jnet, x, want = jax_net_and_input
    path = str(tmp_path / "narrow.params")
    jnet.save_parameters(path)
    net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize(ctx=mxt.cpu())
    net.load_parameters(path)
    onp.testing.assert_allclose(_port_logits(net, x), want, rtol=1e-4,
                                atol=1e-5)
    # and back: the port's file loads into the JAX package
    back = str(tmp_path / "port.params")
    net.save_parameters(back)
    loaded = mx.nd.load(back)
    for k, p in jnet._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(loaded[k].asnumpy(),
                                       p.data().asnumpy())


def test_load_jax_params_rejects_missing_extra_and_shape():
    net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize(ctx=mxt.cpu())
    good = random_weights(2)
    with pytest.raises(mxt.MXNetError, match="missing"):
        load_jax_params(net, {k: v for k, v in good.items()
                              if k != "output.bias"})
    with pytest.raises(mxt.MXNetError, match="left over"):
        load_jax_params(net, dict(good, extra=onp.zeros(1, "float32")))
    bad = dict(good)
    bad["output.weight"] = onp.zeros((10, 64), "float32")
    with pytest.raises(mxt.MXNetError, match="shape"):
        load_jax_params(net, bad)


def test_resnet50_v1_structure_matches_jax():
    """Same structural names, in the same order, with the same (partly
    deferred) shapes — checked without running either net."""
    jp = jresnet.resnet50_v1()._collect_params_with_prefix()
    tp = tresnet.resnet50_v1()._collect_params_with_prefix()
    assert list(jp) == list(tp)
    assert len(tp) == 267
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
    n_fused = sum(1 for k in tp if k.endswith("body.7.gamma"))
    assert n_fused == 16     # one BN -> add -> ReLU epilogue per unit


def test_pretrained_and_v2_raise(tmp_path, monkeypatch):
    """No weights ship: ``pretrained=True`` raises for v1 and v2 alike
    (v2 itself builds since it was ported); an unknown version raises."""
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tresnet.resnet18_v1(pretrained=True)
    with pytest.raises(FileNotFoundError):
        tresnet.get_resnet(2, 18, pretrained=True, prefix="v2raise_")
    with pytest.raises(ValueError):
        tresnet.get_resnet(3, 50)
