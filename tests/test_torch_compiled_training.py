"""Compiled training on the CPU: a hybridized block called under
``autograd.record()`` as a ``cuda_graph.CapturedPair`` (a
``torch.autograd.Function`` whose forward and backward are the pair's) and
``Trainer.step``'s update as one ``Captured`` per key, against the JAX
package's hybridized block (its jitted forward on the tape, the vjp of the
jitted function) and its ``_FusedUpdate``, from the same numpy weights
(``load_jax_params``) and batches.  On the CPU each call runs the bodies:
the protocol of the card without the capture (``chip_smoke.py``'s compiled
training phase holds the replays there to the bits of the eager loop).

Models: an MLP with BatchNorm (batch 5 of 7 features, 3 classes), a
thumbnail ResNetV1 (one basic block a stage, widths 8-64, batch 2 x 3 x
32 x 32, 10 classes) and ``bert_small`` (2 layers, 64 units, 4 heads, 97
words, batch 2 x 16 with valid lengths (16, 9), 3 masked positions a
row, ``MXNET_FUSED_LAYERNORM=1``).  Three steps each.

Tolerances: float32 losses within rtol 1e-5, gradients of the first step
within a relative L2 error of 1e-4 a parameter, weights and running
statistics after the steps within 1e-5 absolute (the same arithmetic
summed in another order; the ResNet's weights and the BERT's within the
bounds of tests/test_torch_train.py and tests/test_torch_bert_train.py:
1e-5 and 3 lr / 50); bfloat16 with ``multi_precision``: losses within
rtol 2e-2, the fp32 masters within 2e-2 relative L2 of the JAX package's
(both round the forward's ops to bfloat16, in other orders).  Every case
also holds the graphed port to its eager loop (``hybridize(False)``
inside ``cuda_graph.disabled()``) to the bits.

The three cases of ``gluon/block.py``'s docstring, each against the JAX
package: two calls of one key in one ``record()`` (a second pair, none
after; one backward of their sum, or a backward each in either order
with ``grad_req`` ``'add'``), ``autograd.grad(..., create_graph=True)`` (second derivatives
through the eager rerun), inputs that ``attach_grad`` (with ``grad_req``
``'add'``); dropout in train mode (a new mask each replay, the backward
reading its own); a rule without ``make_step`` (NAG) updating eagerly;
``donate_grads``; the store's update (``update_on_kvstore``) through the
same graph; the captured update's bits against ``_trainer_update`` for
SGD (with and without momentum), Adam and AdamW in float32, bfloat16 and
bfloat16 with ``multi_precision``; the gradient buffers' stable storage;
one build per key over 5 steps (``telemetry.record_compile``).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.utils import materialize_params
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import cuda_graph, telemetry
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.utils import load_jax_params
from test_torch_bert import SMALL

STEPS = 3
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4
BERT_CFG = dict(SMALL, use_pooler=False)
BERT_SEQ, BERT_LENS, BERT_PRED = 16, (16, 9), 3
OPTS = {"sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4}),
        "adam": ("adam", {"learning_rate": 1e-2}),
        "adamw": ("adamw", {"learning_rate": 1e-2, "wd": 0.01}),
        "bert_adam": ("adam", {"learning_rate": 1e-4}),
        "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9})}


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    den = onp.sqrt((want ** 2).sum())
    return onp.sqrt(((got - want) ** 2).sum()) / (den if den else 1.0)


def _flat(losses):
    return onp.concatenate([onp.ravel(v) for v in losses])


def _mlp(pkg, prefix="ctmlp_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="tanh", in_units=7),
                nn.BatchNorm(in_channels=16), nn.Dense(3, in_units=16))
    return net


def _resnet(pkg):
    v = jvision if pkg is mx else tvision
    return v.ResNetV1(v.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                      thumbnail=True, classes=10, prefix="ctres_")


def _bert(pkg):
    return (jbert if pkg is mx else tbert).bert_small(prefix="ctbert_",
                                                      **BERT_CFG)


def _mlp_data(seed):
    rs = onp.random.RandomState(seed)
    return [(rs.randn(5, 7).astype("float32"),
             rs.randint(0, 3, 5).astype("float32")) for _ in range(STEPS)]


def _resnet_data(seed):
    rs = onp.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (2, 3, 32, 32)).astype("float32"),
             rs.randint(0, 10, 2).astype("float32")) for _ in range(STEPS)]


def _bert_data(seed):
    rs = onp.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        tokens = rs.randint(0, 97, (2, BERT_SEQ)).astype("float32")
        pos = onp.sort(onp.stack([rs.choice(min(BERT_LENS), BERT_PRED,
                                            replace=False)
                                  for _ in range(2)]), 1).astype("int32")
        out.append(((tokens, onp.array(BERT_LENS, "int32"), pos),
                    rs.randint(0, 97, (2, BERT_PRED)).astype("float32")))
    return out


def _loss(pkg, model, net, x, y):
    """The model's loss on one batch, recorded (the caller's scope)."""
    nd = pkg.nd
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    if model == "bert":
        tokens, lens, pos = x
        _, logits = net(nd.array(tokens), None, None,
                        nd.array(lens, dtype="int32"),
                        nd.array(pos, dtype="int32"))
        return ce(logits.reshape(-1, 97), nd.array(y).reshape(-1)).mean()
    return ce(net(nd.array(x)), nd.array(y))


MODELS = {"mlp": (_mlp, _mlp_data, (5, 7)),
          "resnet": (_resnet, _resnet_data, (2, 3, 32, 32)),
          "bert": (_bert, _bert_data, None)}


def _settle(pkg, model, net, data):
    """Complete the deferred shapes with one predict-mode forward."""
    with pkg.autograd.predict_mode():
        if model == "bert":
            tokens, lens, pos = data[0][0]
            net(pkg.nd.array(tokens), None, None,
                pkg.nd.array(lens, dtype="int32"),
                pkg.nd.array(pos, dtype="int32"))
        else:
            net(pkg.nd.array(data[0][0]))


_JAX = {}


def _jax_net(model, dtype="float32"):
    """The JAX net of ``model``, hybridized, and its initial weights (one
    net a model and dtype: its jitted forward and vjp compile once)."""
    if (model, dtype) not in _JAX:
        build, data_fn, _ = MODELS[model]
        mx.random.seed(11)
        net = build(mx)
        net.initialize(mx.init.Xavier())
        if model == "bert":
            # one program (materialize_params takes no None input)
            net.hybridize()
            _settle(mx, model, net, data_fn(0))
        else:
            # abstract shapes: nothing of the net compiles op by op
            materialize_params(net, mx.nd.array(data_fn(0)[0][0]))
        rs = onp.random.RandomState(12)
        w0 = {}
        for k, p in net._collect_params_with_prefix().items():
            a = p.data().asnumpy()
            if k.endswith(("running_mean", "beta")):
                a = rs.uniform(-0.2, 0.2, a.shape).astype("float32")
            elif k.endswith(("running_var", "gamma")):
                a = rs.uniform(0.5, 1.5, a.shape).astype("float32")
            w0[k] = a
        if dtype != "float32":
            net.cast(dtype)
        net.hybridize()
        _JAX[model, dtype] = (net, w0)
    return _JAX[model, dtype]


def _params(net):
    return {k: p.data().astype("float32").asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _grads(net):
    return {k: p.grad().astype("float32").asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _run(pkg, model, net, opt, dtype="float32", mp=False, data=None,
         **trainer_kw):
    """STEPS recorded steps of ``net`` through a Trainer of ``opt``: the
    losses, the gradients of the first step, the weights after, the
    trainer."""
    name, params = OPTS[opt]
    params = dict(params, multi_precision=True) if mp else params
    trainer = pkg.gluon.Trainer(net.collect_params(), name, params,
                                **trainer_kw)
    losses, first = [], None
    data = data if data is not None else MODELS[model][1](1)
    for x, y in data:
        if dtype != "float32" and model != "bert":
            x = x.astype("float32")
        with pkg.autograd.record():
            loss = _loss(pkg, model, net, x, y)
            if dtype != "float32":
                loss = loss.astype("float32")
        loss.backward()
        if first is None:
            first = _grads(net)
        trainer.step(len(y) if model != "bert" else 1,
                     ignore_stale_grad=model == "bert")
        losses.append(loss.asnumpy())
    return losses, first, _params(net), trainer


def _jax_run(model, opt, dtype="float32", mp=False, **kw):
    net, w0 = _jax_net(model, dtype)
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(w0[k]).astype(p.data().dtype))
    return _run(mx, model, net, opt, dtype, mp, **kw)


def _port_net(model, dtype="float32"):
    build, data_fn, _ = MODELS[model]
    _, w0 = _jax_net(model)
    with mxt.cpu():
        net = build(mxt)
        net.initialize()
        _settle(mxt, model, net, data_fn(0))
        load_jax_params(net, w0)
        if dtype != "float32":
            net.cast(dtype)
    return net


def _port_run(model, opt, graphed, dtype="float32", mp=False, **kw):
    net = _port_net(model, dtype)
    net.hybridize(graphed)
    with mxt.cpu():
        if graphed:
            out = _run(mxt, model, net, opt, dtype, mp, **kw)
        else:
            with cuda_graph.disabled():
                out = _run(mxt, model, net, opt, dtype, mp, **kw)
    return out + (net,)


@pytest.fixture(autouse=True)
def fused_layernorm(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")


CASES = [("mlp", "sgd_momentum", "float32"), ("mlp", "adam", "float32"),
         ("mlp", "adamw", "float32"), ("mlp", "sgd_momentum", "bf16_mp"),
         ("resnet", "sgd_momentum", "float32"),
         ("bert", "bert_adam", "float32")]


@pytest.mark.parametrize("model,opt,mode", CASES,
                         ids=["-".join(c) for c in CASES])
def test_recorded_pair_and_captured_update_match_jax(model, opt, mode):
    dtype, mp = ("bfloat16", True) if mode == "bf16_mp" else ("float32",
                                                                False)
    before = telemetry.compile_counts()
    tl, tg, tw, trainer, net = _port_run(model, opt, True, dtype, mp)
    built = telemetry.compile_deltas(before)
    el, eg, ew, _, _ = _port_run(model, opt, False, dtype, mp)
    # the graphed loop gives the bits of the eager one
    for a, b in zip(tl, el):
        onp.testing.assert_array_equal(a, b)
    for k in ew:
        onp.testing.assert_array_equal(tw[k], ew[k], err_msg=k)
        onp.testing.assert_array_equal(tg.get(k), eg.get(k), err_msg=k)
    # one pair and one update graph, each built once
    (key, (rec, _)), = net._cached_graph._cache.items()
    assert key[:2] == (True, True) and len(rec.pairs) == 1
    assert len(trainer._fused._cache) == 1
    assert built == {"CachedOp_" + net.name: 1,
                     "FusedUpdate[%x]" % id(trainer._fused): 1}
    jl, jg, jw, _ = _jax_run(model, opt, dtype, mp)
    if mp:
        onp.testing.assert_allclose(_flat(tl), _flat(jl), rtol=2e-2)
        masters = {trainer._params[i].name: s[0].asnumpy()
                   for i, s in trainer._updater.states.items()}
        names = {p.name: k for k, p in
                 net._collect_params_with_prefix().items()}
        for name, m in masters.items():
            assert _rel(m, jw[names[name]]) <= 2e-2, name
        return
    onp.testing.assert_allclose(_flat(tl), _flat(jl), **F32)
    for k in jg:
        assert _rel(tg[k], jg[k]) <= GRAD_REL, k
    atol = 3 * 1e-4 / 50 if model == "bert" else 1e-5
    for k in jw:
        onp.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=atol,
                                    err_msg=k)
    if model != "bert":
        assert any(k.endswith("running_mean")
                   and not onp.array_equal(tw[k], _jax_net(model)[1][k])
                   for k in tw)


def _mlp_pair():
    return _jax_net("mlp")[0], _port_net("mlp")


def _reset_jax(net):
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(_jax_net("mlp")[1][k]))


def test_grad_req_add_and_an_attached_input_match_jax():
    jnet, tnet = _mlp_pair()
    _reset_jax(jnet)
    (x, _), = _mlp_data(2)[:1]
    got = {}
    for key, pkg, net in (("jax", mx, jnet), ("port", mxt, tnet)):
        with pkg.cpu():
            net.hybridize()
            net.collect_params().setattr("grad_req", "add")
            net.collect_params().zero_grad()
            xx = pkg.nd.array(x)
            xx.attach_grad()
            for _ in range(2):
                with pkg.autograd.record():
                    y = net(xx)
                    loss = (y * y).sum()
                loss.backward()
            got[key] = (_grads(net), xx.grad.asnumpy())
            net.collect_params().setattr("grad_req", "write")
    for k, v in got["jax"][0].items():
        assert _rel(got["port"][0][k], v) <= GRAD_REL, k
    onp.testing.assert_allclose(got["port"][1], got["jax"][1], **F32)
    (_, (rec, _)), = tnet._cached_graph._cache.items()
    assert rec.needs == (True,) and len(rec.pairs) == 1


def test_two_calls_of_one_key_take_a_second_pair_and_match_jax():
    jnet, tnet = _mlp_pair()
    _reset_jax(jnet)
    data = _mlp_data(3)
    got = {}
    for key, pkg, net in (("jax", mx, jnet), ("port", mxt, tnet)):
        with pkg.cpu():
            net.hybridize()
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            builds = []
            for (x1, y1), (x2, y2) in zip(data, data[1:] + data[:1]):
                before = telemetry.compile_counts()
                with pkg.autograd.record():
                    loss = ce(net(pkg.nd.array(x1)), pkg.nd.array(y1)) + \
                        ce(net(pkg.nd.array(x2)), pkg.nd.array(y2))
                loss.backward()
                trainer.step(5)
                builds.append(sum(telemetry.compile_deltas(before)
                                  .values()))
            got[key] = (_params(net), builds)
    for k, v in got["jax"][0].items():
        onp.testing.assert_allclose(got["port"][0][k], v, err_msg=k, **F32)
    assert got["port"][1] == [3, 0, 0]          # two pairs, one update
    (_, (rec, _)), = tnet._cached_graph._cache.items()
    assert len(rec.pairs) == 2 and not any(p.busy for p in rec.pairs)


def test_two_calls_with_a_backward_each_in_either_order_match_jax():
    jnet, tnet = _mlp_pair()
    _reset_jax(jnet)
    data = _mlp_data(6)
    got = {}
    for key, pkg, net in (("jax", mx, jnet), ("port", mxt, tnet)):
        with pkg.cpu():
            net.hybridize()
            net.collect_params().setattr("grad_req", "add")
            net.collect_params().zero_grad()
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1,
                                         "momentum": 0.9})
            ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            losses = []
            for s, ((x1, y1), (x2, y2)) in enumerate(zip(data,
                                                         data[::-1])):
                with pkg.autograd.record():
                    l1 = ce(net(pkg.nd.array(x1)), pkg.nd.array(y1))
                    l2 = ce(net(pkg.nd.array(x2)), pkg.nd.array(y2))
                for loss in ((l1, l2) if s % 2 == 0 else (l2, l1)):
                    loss.backward()
                trainer.step(10)
                net.collect_params().zero_grad()
                losses += [l1.asnumpy(), l2.asnumpy()]
            net.collect_params().setattr("grad_req", "write")
            got[key] = (losses, _params(net))
    onp.testing.assert_allclose(_flat(got["port"][0]), _flat(got["jax"][0]),
                                **F32)
    for k, v in got["jax"][1].items():
        onp.testing.assert_allclose(got["port"][1][k], v, err_msg=k, **F32)
    (_, (rec, _)), = tnet._cached_graph._cache.items()
    assert len(rec.pairs) == 2 and not any(p.busy for p in rec.pairs)


def test_create_graph_second_derivatives_match_jax():
    jnet, tnet = _mlp_pair()
    _reset_jax(jnet)
    (x, _), = _mlp_data(4)[:1]
    got = {}
    for key, pkg, net in (("jax", mx, jnet), ("port", mxt, tnet)):
        with pkg.cpu():
            net.hybridize()
            xx = pkg.nd.array(x)
            xx.attach_grad()
            with pkg.autograd.record():
                y = net(xx)
                gx = pkg.autograd.grad((y * y).sum(), [xx],
                                       create_graph=True)[0]
                z = (gx * gx).sum()
            z.backward()
            got[key] = (gx.asnumpy(), xx.grad.asnumpy(), _grads(net))
    onp.testing.assert_allclose(got["port"][0], got["jax"][0], **F32)
    onp.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-4,
                                atol=1e-5)
    # BatchNorm's beta barely reaches the second derivative (1e-5 against
    # gradients of 1e-1): each parameter is held against the largest
    scale = max(onp.abs(v).max() for v in got["jax"][2].values())
    for k, v in got["jax"][2].items():
        onp.testing.assert_allclose(got["port"][2][k], v, rtol=1e-4,
                                    atol=1e-4 * scale, err_msg=k)


def test_dropout_draws_a_mask_each_replay_and_its_backward_reads_it():
    x = onp.random.RandomState(5).uniform(1, 2, (64, 8)).astype("float32")
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.cpu():
            net = pkg.gluon.nn.Dropout(0.5, prefix="ctdrop_")
            net.hybridize()
            masks = []
            for _ in range(2):
                xx = pkg.nd.array(x)
                xx.attach_grad()
                with pkg.autograd.record():
                    y = net(xx)
                y.backward()
                y, g = y.asnumpy(), xx.grad.asnumpy()
                # the gradient is the forward's own mask, scaled
                onp.testing.assert_array_equal(g, (y != 0) * 2.0)
                onp.testing.assert_allclose(y, x * g, rtol=1e-6)
                masks.append(y != 0)
            got[key] = masks
    for a, b in got.values():
        assert not onp.array_equal(a, b) and 0.3 < a.mean() < 0.7


def test_rule_without_make_step_updates_eagerly_as_jax():
    jl, _, jw, _ = _jax_run("mlp", "nag")
    before = telemetry.compile_counts()
    tl, _, tw, trainer, net = _port_run("mlp", "nag", True)
    built = telemetry.compile_deltas(before)
    assert built == {"CachedOp_" + net.name: 1}
    assert not trainer._fused._cache
    onp.testing.assert_allclose(_flat(tl), _flat(jl), **F32)
    for k in jw:
        onp.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                    err_msg=k)


def test_donate_grads_trainer_steps_to_jax_weights():
    _, _, jw, _ = _jax_run("mlp", "sgd_momentum", donate_grads=True)
    _, _, tw, trainer, _ = _port_run("mlp", "sgd_momentum", True,
                                     donate_grads=True)
    assert trainer._donate_grads and len(trainer._fused._cache) == 1
    for k in jw:
        onp.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                    err_msg=k)


def test_update_on_kvstore_takes_the_same_graph():
    _, _, plain, _, _ = _port_run("mlp", "sgd_momentum", True,
                                  kvstore=None)
    _, _, stored, trainer, _ = _port_run("mlp", "sgd_momentum", True,
                                         kvstore="device",
                                         update_on_kvstore=True)
    assert trainer._update_on_kvstore and len(trainer._fused._cache) == 1
    for k in plain:
        onp.testing.assert_array_equal(stored[k], plain[k], err_msg=k)


UPDATE_OPTS = {"sgd": ("sgd", {"learning_rate": 0.1, "wd": 1e-4,
                               "rescale_grad": 0.5}),
               "sgd_momentum": ("sgd", {"learning_rate": 0.1,
                                        "momentum": 0.9, "wd": 1e-4}),
               "adam": ("adam", {"learning_rate": 1e-2, "wd": 1e-4}),
               "adamw": ("adamw", {"learning_rate": 1e-2, "wd": 0.01})}


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_mp"])
@pytest.mark.parametrize("opt", sorted(UPDATE_OPTS))
def test_captured_update_gives_the_bits_of_the_eager_update(opt, mode):
    rs = onp.random.RandomState(13)
    shapes = [(6, 5), (6,), (3, 6), (3,)]
    w0 = [rs.randn(*s).astype("float32") for s in shapes]
    gs = [[rs.randn(*s).astype("float32") for s in shapes]
          for _ in range(STEPS)]
    dtype = "float32" if mode == "f32" else "bfloat16"
    got = []
    for graphed in (True, False):
        with mxt.cpu():
            params = []
            for i, w in enumerate(w0):
                p = mxt.gluon.Parameter("ctupd%d_weight" % i,
                                        shape=w.shape)
                p.initialize()
                p.set_data(mxt.nd.array(w).astype(dtype))
                params.append(p)
            name, kw = UPDATE_OPTS[opt]
            sched = mxt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
            trainer = mxt.gluon.Trainer(
                params, name, dict(kw, lr_scheduler=sched,
                                   multi_precision=mode == "bf16_mp"))
            for g in gs:
                for p, v in zip(params, g):
                    p.grad()._data.copy_(torch.from_numpy(v))
                    p.data()._fresh_grad = True
                if graphed:
                    trainer.step(2)
                else:
                    with cuda_graph.disabled():
                        trainer.step(2)
            got.append(([p.data().astorch().clone() for p in params],
                        [s for st in trainer._updater.states.values()
                         for s in (st if isinstance(st, tuple) else [st])
                         if s is not None], trainer))
    (gw, gst, gtr), (ew, est, etr) = got
    assert len(gtr._fused._cache) == 1 and not etr._fused._cache
    for a, b in zip(gw, ew):
        assert torch.equal(a, b)
    flat = lambda st: [t for s in st for t in (  # noqa: E731
        s if isinstance(s, tuple) else [s])]
    for a, b in zip(flat(gst), flat(est)):
        assert torch.equal(a.astorch(), b.astorch())


def test_write_gradients_land_in_stable_buffers():
    net = _port_net("mlp")
    net.hybridize()
    with mxt.cpu():
        trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        params = list(net.collect_params().values())
        ptrs, seen = None, []
        for x, y in _mlp_data(6):
            with mxt.autograd.record():
                loss = _loss(mxt, "mlp", net, x, y)
            loss.backward()
            grads = [p.grad() for p in params if p.grad_req != "null"]
            now = [g.astorch().data_ptr() for g in grads]
            assert ptrs is None or now == ptrs
            ptrs = now
            seen.append([g.asnumpy() for g in grads])
            trainer.step(5)
    # each step's gradients, read between backward and step, are that
    # step's: they moved, and the eager loop reads the same
    assert not onp.array_equal(seen[0][0], seen[1][0])
    _, first, _, _, _ = _port_run("mlp", "sgd_momentum", False,
                                  data=_mlp_data(6))
    names = [k for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"]
    for k, g in zip(names, seen[0]):
        onp.testing.assert_array_equal(g, first[k], err_msg=k)


def test_one_build_per_key_over_five_steps():
    net = _port_net("mlp")
    net.hybridize()
    data = _mlp_data(7) + _mlp_data(8)[:2]
    with mxt.cpu():
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-2})
        before = telemetry.compile_counts()
        for x, y in data:
            with mxt.autograd.record():
                loss = _loss(mxt, "mlp", net, x, y)
            loss.backward()
            trainer.step(5)
        assert telemetry.compile_deltas(before) == {
            "CachedOp_" + net.name: 1,
            "FusedUpdate[%x]" % id(trainer._fused): 1}
        # another batch size: a key of its own, and a new update
        # (rescale_grad is baked in, as in the JAX package's key)
        x, y = data[0]
        with mxt.autograd.record():
            loss = _loss(mxt, "mlp", net, x[:4], y[:4])
        loss.backward()
        trainer.step(4)
        assert telemetry.compile_deltas(before) == {
            "CachedOp_" + net.name: 2,
            "FusedUpdate[%x]" % id(trainer._fused): 2}
