"""Port parity: training through ``autograd.record``/``backward`` and
``gluon.Trainer`` in ``mxnet_tpu_torch`` against the JAX package, on the
CPU, from the same numpy weights and data.

* The Gluon MLP of config 1 (784-128-64-10, batch 8), 3 steps of
  SGD with momentum, NAG and Adam: weights and optimizer states within 1e-5
  absolute; Adam within 1e-4, because its early steps are close to
  ``lr * g / |g|`` and a gradient near zero magnifies a rounding difference.
* The narrow ResNetV1 of tests/test_torch_parity.py (2x3x64x64), one SGD
  step (momentum 0.9, wd 1e-4): loss within rel 1e-5; each gradient within
  a relative L2 error of 1e-4 (the convolutions sum in another order
  through 16 layers); updated weights and moving statistics within 1e-5
  absolute.  At 32x32 the last stage is 1x1, so at batch 2 its one-pass
  batch variance comes from two values per channel and the two packages'
  losses already differ by 8e-5 in training mode; 64x64 gives four values
  and agreement to 3e-7.
* Weight decay per parameter (a large wd, so that decaying a parameter
  the JAX package leaves alone, or the reverse, shows), the optimizer-state
  files of either package read by the other, and MXNet's autograd rules:
  write/add gradients, ones as the default head gradient, ``pause``,
  no graph outside ``record``, stale gradients.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.ops import fused_norm as TFN
from test_torch_parity import NARROW, jax_narrow, random_weights

BATCH = 8


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(128, activation="relu"),
                nn.Dense(64, activation="relu"), nn.Dense(10))
    return net


@pytest.fixture(scope="module")
def mlp_setup():
    rng = onp.random.RandomState(0)
    x = rng.uniform(-1, 1, (BATCH, 784)).astype("float32")
    y = rng.randint(0, 10, BATCH).astype("float32")
    shapes = {"0.weight": (128, 784), "0.bias": (128,),
              "1.weight": (64, 128), "1.bias": (64,),
              "2.weight": (10, 64), "2.bias": (10,)}
    weights = {k: (rng.randn(*s) * (0.05 if len(s) > 1 else 0.1))
               .astype("float32") for k, s in shapes.items()}
    return x, y, weights


def _jax_mlp(weights):
    net = _mlp(mx)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.shape = weights[name].shape
        p.set_data(mx.nd.array(weights[name]))
    return net


def _port_mlp(weights):
    net = _mlp(mxt)
    net.initialize(ctx=mxt.cpu())
    net(mxt.nd.zeros((1, 784), ctx=mxt.cpu()))
    load_jax_params(net, weights)
    return net


def _jax_train(net, trainer, x, y, steps, loss_fn=None):
    loss_fn = loss_fn or jgluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = mx.nd.array(x), mx.nd.array(y)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses


def _port_train(net, trainer, x, y, steps):
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    xs = mxt.nd.array(x, ctx=mxt.cpu())
    ys = mxt.nd.array(y, ctx=mxt.cpu())
    losses = []
    for _ in range(steps):
        with mxt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jax_states(trainer):
    store = trainer._kvstore
    updater = store._updater if store is not None and \
        getattr(store, "_updater", None) is not None else trainer._updaters
    return updater.states


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [onp.asarray(s.asnumpy()) for s in state]
    return [state.asnumpy()]


OPTIMIZERS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
               1e-5),
              ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
               1e-5),
              ("adam", {"learning_rate": 0.01, "wd": 1e-4}, 1e-4)]


@pytest.mark.parametrize("name,params,tol", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_mlp_trainer_matches_jax(mlp_setup, name, params, tol):
    x, y, weights = mlp_setup
    jnet, tnet = _jax_mlp(weights), _port_mlp(weights)
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(params))
    ttr = tgluon.Trainer(tnet.collect_params(), name, dict(params))
    jl = _jax_train(jnet, jtr, x, y, 3)
    tl = _port_train(tnet, ttr, x, y, 3)
    onp.testing.assert_allclose(tl, jl, rtol=max(tol, 1e-5))
    assert tl[-1] < tl[0]
    jp, tp = _params(jnet), _params(tnet)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=tol, err_msg=k)
    js, ts = _jax_states(jtr), ttr._updater.states
    assert sorted(js) == sorted(ts)
    for i in js:
        for a, b in zip(_leaves(ts[i]), _leaves(js[i])):
            onp.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_weight_decay_per_parameter_matches_jax(mlp_setup):
    """wd 0.5: the JAX Trainer decays every parameter, biases included,
    by its own ``wd_mult`` (1 unless set; here 0 for the first layer's
    bias) and scales its lr by ``lr_mult`` (here 0.5 for the last layer);
    a port that spared a bias by its name, decayed the exempt one or
    dropped a multiplier would be off by lr*wd*|w|."""
    x, y, weights = mlp_setup
    jnet, tnet = _jax_mlp(weights), _port_mlp(weights)
    for net in (jnet, tnet):
        net._collect_params_with_prefix()["0.bias"].wd_mult = 0.0
        net.collect_params(".*dense2_").setattr("lr_mult", 0.5)
    params = {"learning_rate": 0.1, "wd": 0.5}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(params))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(params))
    _jax_train(jnet, jtr, x, y, 1)
    _port_train(tnet, ttr, x, y, 1)
    jp, tp = _params(jnet), _params(tnet)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-6,
                                    err_msg=k)
    n = len(jp)
    assert ttr.optimizer._get_wds(list(range(n))) == \
        jtr.optimizer._get_wds(list(range(n)))
    # the name rule of set_wd_mult applies where names come by index
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma", 3: "bn_beta"}
    assert mxt.optimizer.SGD(wd=0.1, param_idx2name=names)._get_wds(
        [0, 1, 2, 3]) == mx.optimizer.SGD(
            wd=0.1, param_idx2name=names)._get_wds([0, 1, 2, 3])


@pytest.fixture(scope="module")
def resnet_step():
    """One SGD step of the narrow ResNetV1 in both packages."""
    weights = random_weights(3)
    rng = onp.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype("float32")
    y = onp.array([1, 7], "float32")
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jnet = jax_narrow(weights)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(params))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        jloss = jloss_fn(jnet(mx.nd.array(x)), mx.nd.array(y))
    jloss.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    jtr.step(2)

    tnet = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    tnet.initialize(ctx=mxt.cpu())
    load_jax_params(tnet, weights)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(params))
    tloss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    fwd, bwd = TFN.LAUNCHES, TFN.BWD_LAUNCHES
    with mxt.autograd.record():
        tloss = tloss_fn(tnet(mxt.nd.array(x, ctx=mxt.cpu())),
                         mxt.nd.array(y, ctx=mxt.cpu()))
    tloss.backward()
    tgrads = {k: p.grad().asnumpy()
              for k, p in tnet._collect_params_with_prefix().items()
              if p.grad_req != "null"}
    ttr.step(2)
    assert (TFN.LAUNCHES, TFN.BWD_LAUNCHES) == (fwd, bwd)
    # every parameter, betas and biases included, decays as in the JAX
    # package (its own wd_mult): exactly the same per-index rates
    n = len(ttr._params)
    assert ttr.optimizer._get_wds(list(range(n))) == \
        jtr.optimizer._get_wds(list(range(n)))
    return (jloss.asnumpy(), tloss.asnumpy(), jgrads, tgrads, _params(jnet),
            _params(tnet), tnet)


def test_resnet_step_loss_and_grads_match_jax(resnet_step):
    jloss, tloss, jgrads, tgrads = resnet_step[:4]
    onp.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(jgrads) == sorted(tgrads) and len(tgrads) == 53
    for k, want in jgrads.items():
        err = onp.linalg.norm(tgrads[k] - want) / onp.linalg.norm(want)
        assert err <= 1e-4, (k, err)


def test_resnet_step_weights_and_moving_stats_match_jax(resnet_step):
    jp, tp, tnet = resnet_step[4:]
    assert sorted(jp) == sorted(tp)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5,
                                    err_msg=k)
    # no graph outlives the step: parameters are leaves, statistics plain
    for k, p in tnet._collect_params_with_prefix().items():
        t = p.data().astorch()
        assert t.grad_fn is None and t.is_leaf, k
        assert t.requires_grad == (p.grad_req != "null"), k


def test_states_files_cross_between_packages(mlp_setup, tmp_path):
    """Two JAX steps, its states file loaded by the port, one more step on
    each side; then the port's file loaded by the JAX package."""
    x, y, weights = mlp_setup
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jnet = _jax_mlp(weights)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(params))
    _jax_train(jnet, jtr, x, y, 2)
    jfile = str(tmp_path / "jax.states")
    jtr.save_states(jfile)

    tnet = _port_mlp(_params(jnet))
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(params))
    ttr.load_states(jfile)
    assert ttr.optimizer.momentum == 0.9 and ttr.optimizer.num_update == 2
    _jax_train(jnet, jtr, x, y, 1)
    _port_train(tnet, ttr, x, y, 1)
    jp, tp = _params(jnet), _params(tnet)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5)

    tfile = str(tmp_path / "port.states")
    ttr.save_states(tfile)
    jnet2 = _jax_mlp(tp)
    jtr2 = jgluon.Trainer(jnet2.collect_params(), "sgd", dict(params))
    jtr2.load_states(tfile)
    assert type(jtr2.optimizer) is mx.optimizer.SGD
    assert jtr2.optimizer.num_update == 3
    _jax_train(jnet2, jtr2, x, y, 1)
    _port_train(tnet, ttr, x, y, 1)
    jp2, tp2 = _params(jnet2), _params(tnet)
    for k in jp2:
        onp.testing.assert_allclose(tp2[k], jp2[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add_match_jax(req):
    """Two backwards: 'write' keeps the last gradient, 'add' the sum;
    a head gradient of None seeds ones."""
    a = onp.array([1.0, -2.0, 3.0], "float32")
    got = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        v = pkg.nd.array(a, **kw)
        v.attach_grad(req)
        for scale in (2.0, 3.0):
            with pkg.autograd.record():
                out = v * v * scale
            out.backward()
        got.append(v.grad.asnumpy())
    onp.testing.assert_allclose(got[1], got[0], rtol=1e-6)
    want = 2 * a * 3.0 if req == "write" else 2 * a * 5.0
    onp.testing.assert_allclose(got[1], want, rtol=1e-6)


def test_autograd_records_only_inside_record():
    with mxt.cpu():
        v = mxt.nd.array([1.0, 2.0])
        v.attach_grad()
        assert (v * 2).astorch().grad_fn is None
        with mxt.autograd.record():
            w = v * 3
            with mxt.autograd.pause():
                assert (v * 2).astorch().grad_fn is None
                assert not torch.is_grad_enabled()
            assert mxt.autograd.is_training()
        assert w.astorch().grad_fn is not None
        g = mxt.autograd.grad(w, v)
        onp.testing.assert_allclose(g.asnumpy(), [3.0, 3.0])
        assert float(v.grad.asnumpy().sum()) == 0.0   # grad() leaves it
        with pytest.raises(ValueError, match="record"):
            (v * 2).backward()
        # in-place update of a variable keeps it a variable
        v -= 1.0
        assert v.astorch().is_leaf and v.astorch().requires_grad
        with mxt.autograd.record(), pytest.raises(mxt.MXNetError):
            v += 1.0


def test_serving_forward_after_training_builds_no_graph(resnet_step):
    tnet = resnet_step[-1]
    with mxt.autograd.predict_mode():
        out = tnet(mxt.nd.zeros((1, 3, 32, 32), ctx=mxt.cpu()))
    assert out.astorch().grad_fn is None and not out.astorch().requires_grad


def test_stale_gradient_raises_unless_ignored(mlp_setup):
    x, y, weights = mlp_setup
    tnet = _port_mlp(weights)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    _port_train(tnet, ttr, x, y, 1)
    before = _params(tnet)
    with pytest.raises(UserWarning, match="stale|not been updated"):
        ttr.step(BATCH)
    ttr.step(BATCH, ignore_stale_grad=True)
    after = _params(tnet)
    for k in before:
        onp.testing.assert_array_equal(after[k], before[k])


def test_multi_precision_keeps_fp32_master():
    """bf16 weights under multi_precision: the fp32 master takes the fp32
    update and the weight is the master rounded to bf16."""
    with mxt.cpu():
        w = mxt.nd.array(onp.linspace(-1, 1, 6).astype("float32")) \
            .astype("bfloat16")
        g = mxt.nd.array(onp.full(6, 0.3, "float32")).astype("bfloat16")
    w0 = w.astorch().float()
    opt = mxt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                            multi_precision=True)
    upd = mxt.optimizer.get_updater(opt)
    upd(0, g, w)
    master, mom = upd.states[0]
    assert master.astorch().dtype == torch.float32
    ref = w0 - 0.1 * g.astorch().float()
    torch.testing.assert_close(master.astorch(), ref, rtol=0, atol=1e-7)
    assert torch.equal(w.astorch(), master.astorch().to(torch.bfloat16))


def test_custom_function_matches_jax():
    """``autograd.Function`` with a hand-written backward in both
    packages: y = x^3 with dy/dx written out as 3 x^2, scaled by 2 so
    that the result shows it was the custom backward that ran."""
    def make(pkg):
        class Cube(pkg.autograd.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x * x

            def backward(self, dy):
                (x,) = self.saved_tensors
                return dy * x * x * 6.0
        return Cube()

    a = onp.array([-1.5, 0.2, 2.0], "float32")
    got = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        x = pkg.nd.array(a, **kw)
        x.attach_grad()
        with pkg.autograd.record():
            y = make(pkg)(x)
        y.backward()
        got.append((y.asnumpy(), x.grad.asnumpy()))
    for t, j in zip(got[1], got[0]):
        onp.testing.assert_allclose(t, j, rtol=1e-6)
    onp.testing.assert_allclose(got[1][1], 6 * a * a, rtol=1e-6)


def test_optimizer_update_on_one_weight_matches_jax():
    """The optimizer's own ``update`` on one weight (the Module-style
    path), SGD with momentum, twice."""
    w, g = onp.linspace(-1, 1, 5).astype("float32"), \
        onp.linspace(0.5, -0.5, 5).astype("float32")
    out = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.01,
                                rescale_grad=0.5, clip_gradient=0.2)
        weight, grad = pkg.nd.array(w, **kw), pkg.nd.array(g, **kw)
        state = opt.create_state(0, weight)
        for _ in range(2):
            opt.update(0, weight, grad, state)
        out.append((weight.asnumpy(), state.asnumpy()))
    for t, j in zip(out[1], out[0]):
        onp.testing.assert_allclose(t, j, rtol=0, atol=1e-7)


def test_asnumpy_is_a_copy_of_a_parameter_updated_in_place(mlp_setup):
    """Parameters are updated in place, so ``asnumpy`` of a host tensor
    must copy (numpy() alone would share the tensor's memory)."""
    x, y, weights = mlp_setup
    tnet = _port_mlp(weights)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    before = _params(tnet)
    _port_train(tnet, ttr, x, y, 1)
    for k, w in weights.items():
        onp.testing.assert_array_equal(before[k], w)
    assert not onp.array_equal(_params(tnet)["0.weight"], before["0.weight"])


HALF_STEPS = [("sgd", {"learning_rate": 0.1}),
              ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
              ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
              ("adam", {"learning_rate": 0.01})]


def _half_step(pkg, name, params, path, w, g):
    """One update of a bf16 (64, 64) weight without master weights,
    through the Updater or through ``Trainer.step``: the new weight and
    every state leaf, as float32 numpy arrays."""
    kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    if path == "updater":
        upd = pkg.optimizer.get_updater(pkg.optimizer.create(name, **params))
        weight = pkg.nd.array(w, **kw).astype("bfloat16")
        upd(0, pkg.nd.array(g, **kw).astype("bfloat16"), weight)
        state = upd.states[0]
    else:
        p = pkg.gluon.Parameter("w", shape=w.shape, dtype="bfloat16")
        p.initialize(init=pkg.init.Zero(), **kw)
        p.set_data(pkg.nd.array(w, **kw).astype("bfloat16"))
        trainer = pkg.gluon.Trainer([p], name, dict(params))
        if pkg is mxt:
            p.grad().astorch().copy_(torch.from_numpy(g).bfloat16())
            p.data()._fresh_grad = True
            trainer.step(1)
            state = trainer._updater.states[0]
        else:
            p.grad()[:] = mx.nd.array(g).astype("bfloat16")
            trainer.step(1)
            state = _jax_states(trainer)[0]
        weight = p.data()
    leaves = [] if state is None else \
        list(state) if isinstance(state, (tuple, list)) else [state]
    return [a.astype("float32").asnumpy() for a in [weight] + leaves]


@pytest.mark.parametrize("path", ["updater", "trainer"])
@pytest.mark.parametrize("name,params", HALF_STEPS,
                         ids=["sgd", "sgd_momentum", "nag", "adam"])
def test_half_width_update_matches_jax_bits(name, params, path):
    """A bf16 weight without ``multi_precision``: the JAX package rounds
    every hyperparameter to bf16 (its weak-typed Python floats) and every
    operation in bf16; its Trainer's jitted Adam step takes ``lr_t`` in
    fp32.  Exact: the JAX package's bits for the weight and every state."""
    rng = onp.random.RandomState(3)
    w = (rng.randn(64, 64) * 0.5).astype("float32")
    g = (rng.randn(64, 64) * 0.3).astype("float32")
    want = _half_step(mx, name, params, path, w, g)
    got = _half_step(mxt, name, params, path, w, g)
    assert len(got) == len(want) == {"sgd": 1 + ("momentum" in params),
                                     "nag": 2, "adam": 3}[name]
    for t, j in zip(got, want):
        onp.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("owner,method", [
    ("Optimizer", "update"), ("Optimizer", "update_multi_precision"),
    ("Updater", "__call__")])
def test_update_entries_keep_the_jax_signatures(owner, method):
    """The Trainer's choice of arithmetic stays inside the package: the
    public update entries take the JAX package's parameters, no more."""
    import inspect

    def params(pkg):
        fn = getattr(getattr(pkg.optimizer, owner), method)
        return list(inspect.signature(fn).parameters)
    assert params(mxt) == params(mx)
