"""Port parity of float16 models: ``net.cast("float16")`` in
``mxnet_tpu_torch`` against the JAX package, on the CPU, on weights carried
across.

* ``BatchNorm.cast`` (and ``BatchNormAddReLU``'s, inherited) keeps its four
  parameters in float32 when asked for float16, as the JAX package's does;
  bfloat16 casts them.  ``save_parameters`` then writes the JAX package's
  dtypes, and files cross both ways;
* a narrow ``ResNetV1`` (one bottleneck a stage, widths 8..128, 10 classes)
  cast to float16: eval logits at 4 x 3 x 32 x 32, eager and hybridized,
  and a float16 ``AotModel``'s answer, within 1e-2 of the largest |logit|
  (a float16 ulp or two of a value through 16 layers); a float16 server
  fed float32 rows casts them as it assembles the batch, exactly as
  ``astype`` does;
* a SMALL ``ResNetV1`` (the stem and one bottleneck, widths 8 and 16) cast
  to float16, against the JAX package run op by op (its jitted step keeps
  fp32 inside XLA's fusions and lands as far from the port as a float32
  step does; op by op each op rounds to float16 as the port's do):
  - one training-mode forward leaves the JAX package's float32 running
    statistics, within two float16 ulps of the largest product (1 -
    momentum) * statistic, one for the product's rounding and one for a
    statistic moved by an ulp of the activations before it;
  - two ``DataParallelStep`` SGD steps (momentum, weight decay,
    ``multi_precision``, batch 16): the losses within rel 1e-2; after each
    step, what each leaf holds (its float32 master, or the float32
    BatchNorm weight) is compared as an update from the start
    (``_leaf_update_errors``).  The worst leaf within 3e-2: it read 1.3e-2
    and 1.1e-2 when this was written, the port's float32 step 5.2e-2 and
    3.9e-2, the port's step with the loss negated 2.0, a second step left
    out 0.65.  Over all leaves after the first step within 1e-2: read
    2.9e-3, the float32 step 4.3e-2.  The float16 weights and the running
    statistics after both steps within a relative L2 error of 0.1 over
    all parameters (read 3.9e-4).  The float32 masters stay float32, the
    weights their float16 rounding;
* a 2-layer ``bert_small`` (64 units, 97 words) cast to float16 with
  ``MXNET_FUSED_LAYERNORM=1``: the forward's MLM logits within 1e-2 of
  the largest |logit|, and two ``DataParallelStep`` Adam steps with
  ``multi_precision`` against the JAX package's jitted step: the losses
  within rel 1e-2, and after each step
  - each leaf's first moment (the gradient's running mean) within 1e-2
    of the JAX package's (``_leaf_update_errors`` from 0): it read 1.9e-3
    after each step when this was written (2.2e-3 at most over two other
    initialisations), a gradient of the opposite sign reads 2.0, a second
    step left out 0.47;
  - the masters' update over all leaves within a relative L2 error of
    0.2: read 3.5e-2 and 2.0e-2, a step left out 0.50, the opposite sign
    2.0.  An Adam step moves each weight by about lr whatever the size of
    its gradient, so one leaf's update is no measure: a single gradient
    near 0 that rounds to the other sign moves one of LayerNorm's 64
    gammas by 2 lr, 0.25 of that leaf's update.
  Against the jitted step neither check tells float16 from float32 (the
  port's float32 step reads the same), which the SGD check above does.
  The key third of each fused qkv bias is left out (``_drop_key_bias``):
  its gradient is 0 in exact arithmetic, so what is there is rounding
  noise (with it, even the port's float32 step's update reads 0.44 on
  that leaf);
* the attention sublayer's mask branch with valid lengths, whose -1e30
  is not finite in float16, follows the JAX package's promotion to
  float32 (which needed ``batch_dot`` and ``FullyConnected`` to promote
  operands of two dtypes), and the softmax cross entropy of float16
  logits keeps their dtype, as in the JAX package.
"""
import os
import sys

import numpy as onp
import jax
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.serve import AotModel
from test_torch_bert_train import CFG, VOCAB, _inputs as bert_inputs
from test_torch_parity import NARROW, random_weights

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# the update metrics chip_smoke.py holds the card to
from chip_smoke import (  # noqa: E402
    _drop_key_bias, _leaf_update_errors, _update_rel_l2)

LOGIT_REL, LOSS_RTOL, UPDATE_REL_L2 = 1e-2, 1e-2, 0.1
SGD_FIRST_REL_L2, SGD_LEAF_REL = 1e-2, 3e-2
ADAM_MOMENT_REL, ADAM_UPDATE_REL_L2 = 1e-2, 0.2
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4, multi_precision=True)
ADAM_LR, STEPS, TRAIN_BATCH = 1e-4, 2, 16
SMALL = ([1], [8, 16])      # the stem and one bottleneck


def _name(dtype):
    """A dtype's name in either package (the port names bfloat16 as
    torch does: numpy has none)."""
    return str(dtype).replace("torch.", "")


def _dtypes(net):
    return {k: _name(p.data().dtype)
            for k, p in net._collect_params_with_prefix().items()}


def _arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _images(seed, n):
    return onp.random.RandomState(seed).uniform(-1, 1, (n, 3, 32, 32)) \
        .astype("float32")


def _jax_resnet(prefix, weights, arch=NARROW):
    net = jresnet.ResNetV1(jresnet.BottleneckV1, *arch, classes=10,
                           prefix=prefix)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[name]))
    net.cast("float16")
    return net


def _port_resnet(arrays, arch=NARROW, cast=True):
    with mxt.cpu():
        net = tresnet.ResNetV1(tresnet.BottleneckV1, *arch, classes=10)
        net.initialize()
        net(mxt.nd.zeros((1, 3, 32, 32)))
        if cast:
            net.cast("float16")
        if arrays is not None:
            load_jax_params(net, arrays)
    return net


def _small_weights(seed):
    """``random_weights``' rule for SMALL's parameters."""
    rng = onp.random.RandomState(seed)
    out = {}
    for name, p in sorted(_port_resnet(None, SMALL, cast=False)
                          ._collect_params_with_prefix().items()):
        if name.endswith(("running_var", "gamma")):
            out[name] = rng.uniform(0.5, 1.5, p.shape).astype("float32")
        elif name.endswith(("running_mean", "beta", "bias")):
            out[name] = rng.uniform(-0.2, 0.2, p.shape).astype("float32")
        else:
            out[name] = (rng.randn(*p.shape) / onp.sqrt(
                onp.prod(p.shape[1:]))).astype("float32")
    return out


def _f32(arrays):
    return {k: v.astype("float32") for k, v in arrays.items()}


def _host(v):
    """A float32 host copy of a tensor, an NDArray or a JAX array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    elif hasattr(v, "asnumpy"):
        v = v.asnumpy()
    return onp.array(v, "float32")


def _trained(step, net):
    """Structural name -> what each trainable weight holds after the steps,
    in float32: its float32 master under ``multi_precision``, else the
    weight itself (both packages keep the master as state leaf 0)."""
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    return {names[id(step._params[i])]:
            _host(step._opt_states[slot][0] if step._mp_slots[slot]
                  else step._params[i].data())
            for slot, i in enumerate(step._trainable)}


def _first_moments(step, net):
    """Structural name -> Adam's first moment of each trainable weight (the
    state leaf after the float32 master, in both packages)."""
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    return {names[id(step._params[i])]:
            _host(step._opt_states[slot][int(step._mp_slots[slot])])
            for slot, i in enumerate(step._trainable)}


@pytest.fixture(scope="module")
def resnet16():
    """The JAX package's narrow float16 ResNet (hybridized), its arrays
    after the cast and its eval logits on 4 images."""
    jnet = _jax_resnet("f16r_", random_weights(0))
    w16 = _arrays(jnet)
    jnet.hybridize()
    x = _images(1, 4)
    with mx.autograd.predict_mode():
        logits = jnet(mx.nd.array(x).astype("float16"))
    assert str(logits.dtype) == "float16"
    return jnet, w16, x, logits.astype("float32").asnumpy()


@pytest.fixture(scope="module")
def sgd16():
    """The JAX package's SMALL ResNetV1 cast to float16 and two
    ``DataParallelStep`` SGD steps on it, op by op, each op rounding to
    float16 as the port's do (its jitted step keeps fp32 inside XLA's
    fusions).  Returns its float16 arrays before, its arrays after the
    first step (whose forward moved the running statistics), the losses,
    what each step left in float32 (``_trained``) and the net."""
    jnet = _jax_resnet("f16t_", _small_weights(6), SMALL)
    w16 = _arrays(jnet)
    for name, p in jnet._collect_params_with_prefix().items():
        p._data._data = jax.numpy.asarray(w16[name])     # uncommitted
    x, y = _train_batch()
    jstep = mx.parallel.DataParallelStep(
        jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="f16tce_"),
        mx.optimizer.SGD(rescale_grad=1.0 / TRAIN_BATCH, **SGD), mesh=None)
    losses, trained, first = [], [], None
    with jax.disable_jit():
        for _ in range(STEPS):
            losses.append(jstep(mx.nd.array(x).astype("float16"),
                                mx.nd.array(y)))
            trained.append(_trained(jstep, jnet))
            first = first or _arrays(jnet)
    return w16, first, losses, trained, jnet


def _train_batch():
    x = _images(7, TRAIN_BATCH)
    y = onp.random.RandomState(8).randint(0, 10, TRAIN_BATCH) \
        .astype("float32")
    return x, y


# ----------------------------------------------------- BatchNorm.cast (§0)

@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("layer", ["BatchNorm", "BatchNormAddReLU"])
def test_batchnorm_cast_keeps_the_jax_packages_dtypes(layer, dtype):
    jbn = getattr(mx.gluon.nn, layer)(in_channels=4, prefix="f16bn_")
    jbn.initialize()
    jbn.cast(dtype)
    with mxt.cpu():
        tbn = getattr(mxt.gluon.nn, layer)(in_channels=4, prefix="f16bn_")
        tbn.initialize()
        tbn.cast(dtype)
    want = {k: _name(p.data().dtype) for k, p in jbn.collect_params().items()}
    assert {k: _name(p.data().dtype)
            for k, p in tbn.collect_params().items()} == want
    assert set(want.values()) == {"float32" if dtype == "float16"
                                  else dtype}


def test_layernorm_and_dense_cast_to_float16():
    with mxt.cpu():
        net = mxt.gluon.nn.HybridSequential()
        net.add(mxt.gluon.nn.Dense(4, in_units=3),
                mxt.gluon.nn.LayerNorm(in_channels=4))
        net.initialize()
        net.cast("float16")
    assert set(_dtypes(net).values()) == {"float16"}


def test_cast_after_hybridize_captures_again():
    """A hybridized block cast to float16 drops its cached graph (the
    BatchNorm's own cast included) and the next call builds one for the
    float16 parameters, the eager forward's bits."""
    with mxt.cpu():
        net = mxt.gluon.nn.HybridSequential()
        net.add(mxt.gluon.nn.Conv2D(4, 3, in_channels=3),
                mxt.gluon.nn.BatchNorm(in_channels=4))
        net.initialize()
        x = mxt.nd.array(_images(2, 2))
        net.hybridize()
        with mxt.autograd.predict_mode():
            assert net(x).dtype == onp.float32
            assert net._cached_graph is not None
            net.cast("float16")
            assert net._cached_graph is None
            x16 = x.astype("float16")
            got = net(x16)
            graph = net._cached_graph
            assert graph is not None and len(graph._cache) == 1
            net.hybridize(False)
            want = net(x16)
    assert got.dtype == onp.float16
    assert _dtypes(net)["1.gamma"] == "float32"
    assert torch.equal(got.astorch(), want.astorch())


def test_save_parameters_writes_the_jax_packages_dtypes(resnet16, tmp_path):
    jnet, w16, _, _ = resnet16
    net = _port_resnet(w16)
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jnet.save_parameters(jpath)
    net.save_parameters(tpath)
    jfile, tfile = mx.nd.load(jpath), mx.nd.load(tpath)
    assert sorted(jfile) == sorted(tfile)
    for k in jfile:
        assert tfile[k].dtype == jfile[k].dtype, k
        onp.testing.assert_array_equal(tfile[k].asnumpy(),
                                       jfile[k].asnumpy())
    kinds = {k.rsplit(".", 1)[-1]: str(v.dtype) for k, v in tfile.items()}
    assert kinds["running_mean"] == kinds["gamma"] == "float32"
    assert kinds["weight"] == "float16"


def test_weights_cross_both_ways(resnet16, tmp_path):
    """A JAX-package file into a port net cast to float16, and a port file
    into a JAX-package net cast to float16: each side keeps its own
    dtypes (float32 BatchNorm, float16 the rest) and the values."""
    jnet, w16, _, _ = resnet16
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jnet.save_parameters(jpath)
    with mxt.cpu():
        net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
        net.initialize()
        net(mxt.nd.zeros((1, 3, 32, 32)))
        net.cast("float16")
        net.load_parameters(jpath)
    assert _dtypes(net) == _dtypes(jnet)
    for k, v in _arrays(net).items():
        onp.testing.assert_array_equal(v, w16[k])
    net.save_parameters(tpath)
    back = _jax_resnet("f16x_", random_weights(5))
    back.load_parameters(tpath)
    assert _dtypes(back) == _dtypes(jnet)
    for k, v in _arrays(back).items():
        onp.testing.assert_array_equal(v, w16[k])


def test_running_statistics_after_a_training_forward_match_jax(sgd16):
    """One training-mode forward of the SMALL float16 ResNet at batch 16,
    op by op on both sides (the JAX package's is its first step's): the
    float32 running averages of the float16 batch statistics, each scaled
    by the momentum rounded to its operand's dtype."""
    w16, want, _, _, _ = sgd16
    net = _port_resnet(w16, SMALL)
    with mxt.cpu(), torch.no_grad(), mxt.autograd.train_mode():
        net(mxt.nd.array(_train_batch()[0]).astype("float16"))
    got = _arrays(net)
    stats = [k for k in want if "running" in k]
    assert len(stats) == 10
    for k in stats:
        assert got[k].dtype == want[k].dtype == onp.float32, k
        assert not onp.array_equal(want[k], w16[k]), k
        # two float16 ulps of the largest product (1 - m) * statistic: one
        # for the product's rounding, one for a statistic moved by an ulp
        # of the activations before it
        ulp = 2.0 ** (onp.floor(onp.log2(
            onp.abs(want[k] - 0.9 * w16[k]).max())) - 10)
        assert onp.abs(got[k] - want[k]).max() <= 2 * ulp, k


# ------------------------------------------------------ ResNet in float16

def test_get_model_builds_what_the_jax_package_builds():
    """``vision.get_model``, as bench.py builds its nets: the same
    structural names and shapes for resnet50_v1; an unknown name raises
    ValueError, as in the JAX package."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    jp = jvision.get_model("resnet50_v1", classes=1000) \
        ._collect_params_with_prefix()
    tp = tvision.get_model("ResNet50_v1", classes=1000) \
        ._collect_params_with_prefix()
    assert list(tp) == list(jp)
    assert all(tuple(tp[k].shape) == tuple(jp[k].shape) for k in jp)
    with pytest.raises(ValueError):
        tvision.get_model("vgg17")
    with pytest.raises(ValueError):
        jvision.get_model("resnet7_v1")
    with pytest.raises(ValueError):
        tvision.get_model("resnet7_v1")


def test_eval_logits_match_jax_eager_and_hybridized(resnet16):
    _, w16, x, want = resnet16
    net = _port_resnet(w16)
    x16 = mxt.nd.array(x, ctx=mxt.cpu()).astype("float16")
    with torch.inference_mode(), mxt.autograd.predict_mode():
        eager = net(x16)
        net.hybridize()
        hybrid = net(x16)
    assert eager.dtype == hybrid.dtype == onp.float16
    for got in (eager, hybrid):
        got = got.astype("float32").asnumpy()
        assert onp.abs(got - want).max() <= LOGIT_REL * onp.abs(want).max()


def test_float16_aotmodel_answers_match_jax(resnet16):
    """``AotModel.from_block(..., dtype="float16")``: a host batch padded
    into bucket 8 and copied in as float16."""
    _, w16, x, want = resnet16
    net = _port_resnet(w16)
    with mxt.cpu():
        model = AotModel.from_block(net, (3, 32, 32), dtype="float16")
        model.compile_all([8])
    batch = onp.zeros((8, 3, 32, 32), "float16")
    batch[:4] = x
    out = model.run(8, batch)
    assert out.dtype == torch.float16 and tuple(out.shape) == (8, 10)
    got = out[:4].float().numpy()
    assert onp.abs(got - want).max() <= LOGIT_REL * onp.abs(want).max()


def test_float16_server_takes_float32_rows_and_batches_them():
    """A float16 ``AotModel`` behind ``InferenceServer``, fed float32 rows
    (what a float32 client sends): ``submit`` keeps each row as given and
    returns at once, the batch is assembled in float16 (one rounding of
    each value, as ``astype`` gives), a burst of 4 goes out as one bucket-4
    dispatch, and a row of no number type is refused at admission."""
    from mxnet_tpu_torch import serve, telemetry
    w = torch.from_numpy(onp.random.RandomState(12).randn(8, 3)) \
        .to(torch.float16)
    seen = []

    def fn(x):
        seen.append(x.dtype)
        return x @ w
    model = AotModel(fn, feature_shape=(8,), dtype="float16", ctx=mxt.cpu())
    srv = serve.InferenceServer(model, config=serve.ServeConfig(
        buckets=(1, 4), max_queue=16, batch_wait_ms=50.0))
    rows = [onp.random.RandomState(13 + i).randn(8).astype("float32")
            for i in range(4)]
    srv.start()
    try:
        b4 = telemetry.counter("serve.dispatches.b4")
        handles = [srv.submit(r) for r in rows]
        assert all(h.x is r for h, r in zip(handles, rows))
        outs = [h.outcome(timeout=10.0) for h in handles]
        assert telemetry.counter("serve.dispatches.b4") == b4 + 1
        bad = srv.submit(onp.array(["a"] * 8)).outcome(timeout=1.0)
    finally:
        srv.close()
    assert set(seen) == {torch.float16}
    for r, o in zip(rows, outs):
        assert o[0] == "result"
        want = (torch.from_numpy(r.astype("float16")) @ w).numpy()
        onp.testing.assert_array_equal(onp.asarray(o[1]), want)
    assert bad[0] == "reject" and "bad_dtype" in bad[2]


def test_two_sgd_steps_with_multi_precision_match_jax(sgd16):
    w16, _, jl, jw, jnet = sgd16
    net = _port_resnet(w16, SMALL)
    x, y = _train_batch()
    tl, tw = [], []
    with mxt.cpu():
        step = mxt.parallel.DataParallelStep(
            net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
            mxt.optimizer.SGD(rescale_grad=1.0 / TRAIN_BATCH, **SGD),
            mesh=None)
        for _ in range(STEPS):
            tl.append(step(mxt.nd.array(x).astype("float16"),
                           mxt.nd.array(y)))
            tw.append(_trained(step, net))
    assert [str(v.dtype) for v in tl] == [str(v.dtype) for v in jl]
    onp.testing.assert_allclose(
        [float(v.astype("float32").asnumpy()) for v in tl],
        [float(v.astype("float32").asnumpy()) for v in jl], rtol=LOSS_RTOL)
    assert _dtypes(net) == _dtypes(jnet)
    got, want = _f32(_arrays(net)), _f32(_arrays(jnet))
    assert _update_rel_l2(got, want, _f32(w16)) <= UPDATE_REL_L2
    w0 = _f32(w16)
    first = _update_rel_l2(tw[0], jw[0], w0)
    for got, want in zip(tw, jw):
        errs = _leaf_update_errors(got, want, w0)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= SGD_LEAF_REL, (worst, errs[worst], first)
    assert first <= SGD_FIRST_REL_L2, first
    _check_masters(step, net)


def _check_masters(step, net):
    """Every float16 weight has a float32 master in the step's state, of
    which the weight is the float16 rounding; float32 weights none."""
    params = sorted(net.collect_params().items())
    n_half = 0
    for slot, i in enumerate(step._trainable):
        w = params[i][1].data().astorch()
        assert step._mp_slots[slot] == (w.dtype == torch.float16)
        if step._mp_slots[slot]:
            master = step._opt_states[slot][0]
            assert master.dtype == torch.float32
            assert torch.equal(master.half(), w)
            n_half += 1
    assert n_half > 0


# -------------------------------------------------------- BERT in float16

class _JaxMLMLoss(mx.gluon.loss.Loss):
    """bench.py's MLMLoss."""

    def __init__(self, **kwargs):
        super().__init__(weight=None, batch_axis=0, **kwargs)
        with self.name_scope():
            self._ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outputs, lab):
        _, logits = outputs
        return self._ce(logits.reshape(-1, VOCAB), lab.reshape(-1))


class _PortMLMLoss(mxt.gluon.loss.Loss):
    def __init__(self):
        super().__init__(weight=None, batch_axis=0)
        self._ce = mxt.gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outputs, lab):
        _, logits = outputs
        return self._ce(logits.reshape(-1, VOCAB), lab.reshape(-1))


@pytest.fixture(scope="module")
def bert16():
    """The JAX package's 2-layer BERT cast to float16, its arrays, the
    port's net holding them, and the inputs."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_FUSED_LAYERNORM", "1")
    tokens, lens, pos, labels = bert_inputs(0)
    mx.random.seed(3)
    jnet = jbert.bert_small(prefix="f16b_", **CFG)
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()        # one program compiles faster than op by op
    jnet(mx.nd.array(tokens), None, None, mx.nd.array(lens, dtype="int32"),
         mx.nd.array(pos, dtype="int32"))
    jnet.hybridize(False)
    jnet.cast("float16")
    w16 = _arrays(jnet)
    with mxt.cpu():
        net = tbert.bert_small(**CFG)
        net.initialize()
        net(mxt.nd.array(tokens), None, None,
            mxt.nd.array(lens, dtype="int32"),
            mxt.nd.array(pos, dtype="int32"))
        net.cast("float16")
        load_jax_params(net, w16)
    yield jnet, net, w16, (tokens, lens, pos, labels)
    mp.undo()


def _bert_args(pkg, tokens, lens, pos):
    kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    return (pkg.nd.array(tokens, **kw), None, None,
            pkg.nd.array(lens, dtype="int32", **kw),
            pkg.nd.array(pos, dtype="int32", **kw))


def test_bert_forward_matches_jax(bert16):
    jnet, net, w16, (tokens, lens, pos, _) = bert16
    assert _dtypes(net) == _dtypes(jnet)
    assert set(_dtypes(net).values()) == {"float16"}
    jnet.hybridize()
    jseq, jlog = jnet(*_bert_args(mx, tokens, lens, pos))
    jnet.hybridize(False)
    with mxt.cpu(), torch.no_grad():
        seq, logits = net(*_bert_args(mxt, tokens, lens, pos))
    for got, want in ((seq, jseq), (logits, jlog)):
        assert str(got.dtype) == str(want.dtype) == "float16"
        got = got.astype("float32").asnumpy()
        want = want.astype("float32").asnumpy()
        assert onp.isfinite(got).all()
        assert onp.abs(got - want).max() <= LOGIT_REL * onp.abs(want).max()


def test_bert_two_adam_steps_with_multi_precision_match_jax(bert16):
    jnet, net, w16, (tokens, lens, pos, labels) = bert16
    for name, p in jnet._collect_params_with_prefix().items():
        p._data._data = jax.numpy.asarray(w16[name])     # uncommitted
    jstep = mx.parallel.DataParallelStep(
        jnet, _JaxMLMLoss(prefix="f16bl_"),
        mx.optimizer.Adam(learning_rate=ADAM_LR, multi_precision=True),
        mesh=None)
    jl, jw, jm = [], [], []
    for _ in range(STEPS):
        jl.append(jstep(_bert_args(mx, tokens, lens, pos),
                        mx.nd.array(labels)))
        jw.append(_trained(jstep, jnet))
        jm.append(_first_moments(jstep, jnet))
    tl, tw, tm = [], [], []
    with mxt.cpu():
        load_jax_params(net, w16)
        step = mxt.parallel.DataParallelStep(
            net, _PortMLMLoss(),
            mxt.optimizer.Adam(learning_rate=ADAM_LR, multi_precision=True),
            mesh=None)
        for _ in range(STEPS):
            tl.append(step(_bert_args(mxt, tokens, lens, pos),
                           mxt.nd.array(labels)))
            tw.append(_trained(step, net))
            tm.append(_first_moments(step, net))
    assert [str(v.dtype) for v in tl] == [str(v.dtype) for v in jl]
    tl = [float(v.astype("float32").asnumpy()) for v in tl]
    assert all(onp.isfinite(tl))
    onp.testing.assert_allclose(
        tl, [float(v.astype("float32").asnumpy()) for v in jl],
        rtol=LOSS_RTOL)
    assert _dtypes(net) == _dtypes(jnet)
    w0 = _drop_key_bias(_f32(w16))
    zero = {k: onp.zeros_like(v) for k, v in w0.items()}
    for got, want, gm, wm in zip(tw, jw, tm, jm):
        got, want = _drop_key_bias(got), _drop_key_bias(want)
        errs = _leaf_update_errors(_drop_key_bias(gm), _drop_key_bias(wm),
                                   zero)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= ADAM_MOMENT_REL, (worst, errs[worst])
        assert _update_rel_l2(got, want, w0) <= ADAM_UPDATE_REL_L2
    _check_masters(step, net)


# ------------------------------------------- promotion on the float16 path

def test_attention_mask_branch_promotes_as_jax():
    """``MultiHeadAttention`` with an additive mask and valid lengths on
    float16 data: the -1e30 of the padded keys is float32, the scores
    promote to float32 and so does the output, in both packages."""
    rs = onp.random.RandomState(9)
    x = rs.randn(2, 6, 16).astype("float32")
    mask = onp.zeros((2, 1, 6, 6), "float32")
    mask[:, :, :, 4] = -1e4
    vl = onp.array([6, 3], "float32")
    jm = mx.gluon.contrib.nn.MultiHeadAttention(16, 4, prefix="f16mha_")
    jm.initialize()
    jm(mx.nd.array(x))
    jm.cast("float16")
    want = jm(mx.nd.array(x).astype("float16"),
              mx.nd.array(mask).astype("float16"), mx.nd.array(vl))
    with mxt.cpu():
        tm = mxt.gluon.contrib.nn.MultiHeadAttention(16, 4)
        tm.initialize()
        tm(mxt.nd.array(x))
        tm.cast("float16")
        load_jax_params(tm, _arrays(jm))
        got = tm(mxt.nd.array(x).astype("float16"),
                 mxt.nd.array(mask).astype("float16"), mxt.nd.array(vl))
    assert str(got.dtype) == str(want.dtype) == "float32"
    got, want = got.asnumpy(), want.asnumpy()
    assert onp.isfinite(got).all()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["batch_dot", "FullyConnected"])
def test_products_of_two_dtypes_promote_as_jax(op):
    rs = onp.random.RandomState(10)
    a, b = rs.randn(2, 3, 5).astype("float32"), rs.randn(2, 5, 4)
    bias = rs.randn(4).astype("float16")
    if op == "batch_dot":
        args = [(a, "float32"), (b, "float16")]
        kw = {}
    else:
        args = [(a, "float32"), (b[0].T, "float16"), (bias, "float16")]
        kw = {"num_hidden": 4, "flatten": False}
    want = getattr(mx.nd, op)(*[mx.nd.array(v).astype(d) for v, d in args],
                              **kw)
    with mxt.cpu():
        got = getattr(mxt.nd, op)(*[mxt.nd.array(v).astype(d)
                                    for v, d in args], **kw)
    assert str(got.dtype) == str(want.dtype) == "float32"
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-5)


def test_softmax_cross_entropy_of_float16_logits_matches_jax():
    rs = onp.random.RandomState(11)
    logits = (rs.randn(6, 97) * 3).astype("float16")
    labels = rs.randint(0, 97, 6).astype("float32")
    want = mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="f16ce_")(
        mx.nd.array(logits, dtype="float16"), mx.nd.array(labels))
    with mxt.cpu():
        got = mxt.gluon.loss.SoftmaxCrossEntropyLoss()(
            mxt.nd.array(logits, dtype="float16"), mxt.nd.array(labels))
    assert str(got.dtype) == str(want.dtype) == "float16"
    got = got.astype("float32").asnumpy()
    want = want.astype("float32").asnumpy()
    assert onp.isfinite(got).all()
    assert onp.abs(got - want).max() <= LOGIT_REL * onp.abs(want).max()
