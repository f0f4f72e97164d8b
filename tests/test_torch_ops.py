"""Port parity: ``mxnet_tpu_torch/ops/nn.py`` against the JAX package's
registered ops on the same numpy inputs.

float32 tolerance rel 1e-5 (convolution and dense sum in another order on
each side).  bfloat16 BatchNorm is held to the JAX op within 1 bf16 ulp:
plain BatchNorm rounds its folded scale/shift to bf16 before the
multiply-add while BatchNormAddRelu keeps them in fp32, and the port
must reproduce each.
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import nn as jops
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import nn as tops

RTOL = 1e-5


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype("float32")


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(port, jax_out, rtol=RTOL, atol=1e-6):
    onp.testing.assert_allclose(port.numpy(), onp.asarray(jax_out),
                                rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel,stride,pad,bias", [
    ((7, 7), (2, 2), (3, 3), False),      # ResNet stem
    ((3, 3), (1, 1), (1, 1), False),
    ((1, 1), (2, 2), (0, 0), True)])
def test_convolution(kernel, stride, pad, bias):
    x, w, b = _rand((2, 4, 15, 15), 0), _rand((6, 4) + kernel, 1), _rand((6,), 2)
    (xj, wj, bj), (xt, wt, bt) = _both(x, w, b)
    kw = dict(kernel=kernel, stride=stride, pad=pad, num_filter=6,
              no_bias=not bias)
    _close(tops.convolution(xt, wt, bt, **kw),
           jops.convolution(xj, wj, bj, **kw))


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True),
    dict(kernel=(1, 1), pool_type="max", global_pool=True)])
def test_pooling(kw):
    x = _rand((2, 3, 9, 10), 3)
    (xj,), (xt,) = _both(x)
    _close(tops.pooling(xt, **kw), jops.pooling(xj, **kw))


def test_pooling_full_convention_refused():
    """The ``full`` (ceil) convention, once refused, now agrees with the
    JAX op: (1, 1, 6, 6), kernel 3, stride 2 gives 3 x 3 windows."""
    x = _rand((1, 1, 6, 6), 7)
    (xj,), (xt,) = _both(x)
    kw = dict(kernel=(3, 3), stride=(2, 2), pooling_convention="full")
    got = tops.pooling(xt, **kw)
    assert tuple(got.shape) == (1, 1, 3, 3)
    _close(got, jops.pooling(xj, **kw))


@pytest.mark.parametrize("shape,flatten", [((3, 2, 2, 5), True),
                                           ((3, 20), False)])
def test_fully_connected(shape, flatten):
    x, w, b = _rand(shape, 4), _rand((7, 20), 5), _rand((7,), 6)
    (xj, wj, bj), (xt, wt, bt) = _both(x, w, b)
    _close(tops.fully_connected(xt, wt, bt, num_hidden=7, flatten=flatten),
           jops.fully_connected(xj, wj, bj, num_hidden=7, flatten=flatten))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu"])
def test_activation(act):
    x = _rand((4, 9), 7, -3, 3)
    (xj,), (xt,) = _both(x)
    _close(tops.activation(xt, act_type=act), jops.activation(xj, act_type=act))


def _bn_params(c, seed):
    return (_rand((c,), seed, 0.5, 1.5), _rand((c,), seed + 1, -0.2, 0.2),
            _rand((c,), seed + 2, -0.3, 0.3), _rand((c,), seed + 3, 0.5, 1.5))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_f32(training, fix_gamma):
    x = _rand((2, 5, 4, 3), 8)
    arrays = (x,) + _bn_params(5, 9)
    js, ts = _both(*arrays)
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, training=training)
    got = tops.batch_norm(*ts, **kw)
    want = jops.batch_norm(*js, **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_add_relu_f32(training):
    x, res = _rand((2, 5, 4, 3), 10), _rand((2, 5, 4, 3), 11)
    arrays = (x, res) + _bn_params(5, 12)
    js, ts = _both(*arrays)
    kw = dict(eps=1e-5, fix_gamma=False, training=training)
    got = tops.batch_norm_add_relu(*ts, **kw)
    want = jops.batch_norm_add_relu(*js, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(onp.uint16).astype(onp.int64)
    return onp.asarray(a).view(onp.uint16).astype(onp.int64)


def test_batch_norm_bf16_rounding_follows_each_op():
    """bf16 eval BatchNorm (scale/shift rounded to bf16) and
    BatchNormAddRelu (scale/shift kept fp32) each match the JAX op, and
    the two differ from each other, so the test can see the rounding."""
    x, res = _rand((4, 8, 6, 6), 13, -4, 4), _rand((4, 8, 6, 6), 14)
    params = _bn_params(8, 15)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    xj, rj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    rt = torch.from_numpy(res).to(torch.bfloat16)
    kw = dict(eps=1e-5, fix_gamma=False, training=False)
    bn_t = tops.batch_norm(xt, *tp, **kw)[0]
    bn_j = jops.batch_norm(xj, *jp, **kw)[0]
    assert bn_t.dtype == torch.bfloat16
    assert onp.abs(_bits(bn_t) - _bits(bn_j)).max() <= 1
    add_t = tops.batch_norm_add_relu(xt, torch.zeros_like(rt), *tp, **kw)[0]
    add_j = jops.batch_norm_add_relu(xj, jnp.zeros_like(rj), *jp, **kw)[0]
    assert onp.abs(_bits(add_t) - _bits(add_j)).max() <= 1
    # relu(BN(x) + 0) vs relu(BN(x)): equal but for the scale/shift rounding
    relu_bn = torch.relu(bn_t)
    assert not torch.equal(relu_bn, add_t)


@pytest.mark.parametrize("src", [onp.zeros(3), onp.zeros(3, "float32"),
                                 onp.zeros(3, "int32"), [1.0, 2.0]])
def test_array_dtype_follows_jax_package(src):
    """``nd.array`` picks the dtype the JAX package gives the same source
    (its arrays are at most 32-bit, so float64 numpy becomes float32)."""
    want = mx.nd.array(src).dtype
    got = mxt.nd.array(src, ctx=mxt.cpu()).dtype
    assert onp.dtype(got) == onp.dtype(want)


def test_integer_arrays_are_int32_as_in_jax_package():
    """An int64 numpy source becomes int32 (the JAX package's arrays are
    at most 32-bit), in ``nd.array`` and in the batches a DataLoader
    stacks from an integer dataset."""
    src = onp.arange(3)
    assert src.dtype == onp.int64
    assert onp.dtype(mx.nd.array(src).dtype) == onp.int32
    assert onp.dtype(mxt.nd.array(src, ctx=mxt.cpu()).dtype) == onp.int32
    labels = onp.arange(4)
    data = onp.zeros((4, 2), "float32")
    want = [lb.dtype for _, lb in mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(data, labels), batch_size=2)]
    with mxt.cpu():
        got = [lb.dtype for _, lb in mxt.gluon.data.DataLoader(
            mxt.gluon.data.ArrayDataset(data, labels), batch_size=2)]
    assert [onp.dtype(d) for d in got] == [onp.dtype(d) for d in want] \
        == [onp.int32] * 2
