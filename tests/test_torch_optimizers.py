"""Port parity: the optimizer rules of ``mxnet_tpu_torch.optimizer`` that
the rest-of-training slice added (Signum, FTML, LBSGD, DCASGD, SGLD,
AdamW, AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam and Test) against
the JAX package's, on the CPU, from the same numpy weights and
gradients.

* Each rule through its ``Updater``, 3 steps over a mixed set of weights
  (two float32, one bfloat16, one float16) with ``rescale_grad`` and
  ``clip_gradient``, ``multi_precision`` off and on: every weight and
  state leaf in float32 within rtol 1e-6, atol 1e-7 (the eager ops agree
  to the bit but for a rounding here and there, e.g. FTML's
  ``sqrt(v / c)`` and LARS's norms, summed in another order); every
  half-width leaf bit for bit (NaN where the JAX package has NaN: FTML,
  AdamW and Nadam on a float16 weight, whose epsilon 1e-8 rounds to 0).
  SGLD is held by its deterministic part and the mean and spread of its
  noise, since the draws cannot match.
* AdamW's ``make_step`` against the JAX package's ``make_step`` jitted,
  each step from the same values: bfloat16 bit for bit; float32 (and the
  fp32 master of a bfloat16 weight) with at most one element in a
  thousand apart, by at most 2 ulps (XLA contracts multiply-adds and
  folds constants, and the port follows it, but not to the last bit of
  the decayed weight); given its rate as a device scale, the step gives
  the bits of the rate given as a number.
* AdamW through ``DataParallelStep`` against the JAX package's step under
  a schedule (float32 within rtol 1e-5, atol 1e-6; bfloat16 losses within
  rtol 2e-2 and weights within 2 bf16 ulps plus 2 x steps x lr, as
  tests/test_torch_cuda_graph.py holds Adam), and its ZeRO branch on a
  one-rank gloo group with the replicated step's bits.  The other twelve
  rules have no ``make_step`` and raise there, as in the JAX package.
* ``gluon.Trainer`` with each rule against the JAX package's Trainer, and
  the ``save_states`` files of each rule read by the other package in
  both directions (weights within atol 1e-5, as tests/test_torch_train.py).
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.optimizer.optimizer import _f32

F32 = dict(rtol=1e-6, atol=1e-7)
NEW_RULES = ["signum", "ftml", "lbsgd", "dcasgd", "sgld", "adamw", "adagrad",
             "rmsprop", "adadelta", "ftrl", "adamax", "nadam", "test"]
RULES = [
    ("signum", dict(momentum=0.9, wd_lh=0.01, wd=1e-3)),
    ("signum", dict(momentum=0.0)),
    ("ftml", dict(learning_rate=0.01, wd=1e-3)),
    ("lbsgd", dict(momentum=0.9, warmup_epochs=1, updates_per_epoch=2,
                   batch_scale=4, wd=1e-3)),
    ("lbsgd", dict(warmup_strategy="lars", learning_rate=0.1)),
    ("dcasgd", dict(momentum=0.9, learning_rate=0.1)),
    ("dcasgd", dict(learning_rate=0.1, wd=1e-3)),
    ("adamw", dict(learning_rate=0.01, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.5)),
    ("adadelta", dict(wd=1e-3)),
    ("ftrl", dict(learning_rate=0.1, wd=1e-3)),
    ("adamax", dict(wd=1e-3)),
    ("nadam", dict(learning_rate=0.01, wd=1e-3)),
    ("test", dict()),
]
RULE_IDS = ["signum", "signsgd", "ftml", "lbsgd_linear", "lbsgd_lars",
            "dcasgd_momentum", "dcasgd", "adamw", "adagrad", "rmsprop",
            "rmsprop_centered", "adadelta", "ftrl", "adamax", "nadam", "test"]
SHAPES = [((8, 16), "float32"), ((16,), "float32"), ((8, 8), "bfloat16"),
          ((12,), "float16")]


@pytest.fixture(scope="module")
def arrays():
    rng = onp.random.RandomState(0)
    w = [(rng.randn(*s) * 0.5).astype("float32") for s, _ in SHAPES]
    g = [[(rng.randn(*s) * 0.3).astype("float32") for s, _ in SHAPES]
         for _ in range(3)]
    return w, g


def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _state_leaves(s)]
    return [state]


def _updater_run(pkg, name, kw, mp, arrays):
    W, G = arrays
    ckw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    opt = pkg.optimizer.create(name, rescale_grad=0.5, clip_gradient=0.4,
                               multi_precision=mp, **kw)
    upd = pkg.optimizer.get_updater(opt)
    ws = [pkg.nd.array(w, **ckw).astype(dt) for w, (_, dt) in zip(W, SHAPES)]
    for step in G:
        gs = [pkg.nd.array(g, **ckw).astype(dt)
              for g, (_, dt) in zip(step, SHAPES)]
        if pkg is mxt:
            upd(list(range(len(ws))), gs, ws)      # one pass over all
        else:
            for i, (g, w) in enumerate(zip(gs, ws)):
                upd(i, g, w)
    return [[w] + _state_leaves(upd.states[i]) for i, w in enumerate(ws)], \
        opt


def test_every_jax_rule_is_registered():
    # other modules of the JAX package register rules of their own
    names = sorted(n for n, k in mx.optimizer.Optimizer.opt_registry.items()
                   if k.__module__ == "mxnet_tpu.optimizer.optimizer")
    assert sorted(mxt.optimizer.Optimizer.opt_registry) == names
    assert len(names) == 16
    for name in names:
        opt = mxt.optimizer.create(name)
        assert type(opt).__name__.lower() == name
        assert hasattr(mxt.optimizer, type(opt).__name__)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("name,kw", RULES, ids=RULE_IDS)
def test_rule_matches_jax_updater(name, kw, mp, arrays):
    want, jopt = _updater_run(mx, name, kw, mp, arrays)
    got, topt = _updater_run(mxt, name, kw, mp, arrays)
    assert topt.num_update == jopt.num_update
    if name == "nadam":
        assert topt.m_schedule == jopt.m_schedule
    for tl, jl in zip(got, want):
        assert len(tl) == len(jl)
        for t, j in zip(tl, jl):
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
            wide = str(j.dtype) == "float32"
            t = t.astype("float32").asnumpy()
            j = j.astype("float32").asnumpy()
            if wide:
                onp.testing.assert_allclose(t, j, **F32)
            else:
                onp.testing.assert_array_equal(t, j)


def test_sgld_deterministic_part_and_noise_moments():
    """``w - lr / 2 * g`` plus noise of mean 0 and deviation sqrt(lr) in
    both packages (the draws differ)."""
    lr, n = 0.01, 200_000
    rs = onp.random.RandomState(5)
    w = rs.randn(n).astype("float32")
    g = rs.randn(n).astype("float32")
    mxt.random.seed(11)
    noise = {}
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        opt = pkg.optimizer.SGLD(learning_rate=lr, wd=1e-3)
        weight = pkg.nd.array(w.copy(), **kw)
        grad = pkg.nd.array(g.copy(), **kw)
        opt.update(0, weight, grad, opt.create_state(0, weight))
        det = w - lr / 2 * (g + 1e-3 * w)
        noise[pkg.__name__] = weight.asnumpy() - det
    for name, z in noise.items():
        assert abs(z.mean()) < 5 * onp.sqrt(lr / n), name
        assert abs(z.std() / onp.sqrt(lr) - 1) < 0.01, name
    assert not onp.array_equal(noise["mxnet_tpu"], noise["mxnet_tpu_torch"])


ADAMW = dict(learning_rate=1e-2, wd=0.01, rescale_grad=0.3)


def _ulps(a, b):
    ai = a.astype(onp.float32).view(onp.int32).astype(onp.int64)
    bi = b.astype(onp.float32).view(onp.int32).astype(onp.int64)
    return onp.abs(ai - bi).max()


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_mp", "f32_clip"])
def test_adamw_make_step_matches_jitted_jax(mode):
    kw = dict(ADAMW, clip_gradient=0.5) if mode == "f32_clip" else ADAMW
    jopt = mx.optimizer.AdamW(**kw)
    topt = mxt.optimizer.AdamW(**kw)
    rs = onp.random.RandomState(2)
    n = 4099
    w = rs.randn(n).astype("float32")
    m = (rs.randn(n) * 0.1).astype("float32")
    v = (onp.abs(rs.randn(n)) * 0.1).astype("float32")
    half = mode.startswith("bf16")
    jd = jax.numpy.bfloat16 if half else jax.numpy.float32
    if mode == "bf16_mp":
        jd = jax.numpy.float32      # the master and its fp32 state
    jstep = jax.jit(jopt.make_step(0))
    tstep = topt.make_step(0)
    jw, jm, jv = [jax.numpy.asarray(a).astype(jd) for a in (w, m, v)]
    tw, tm, tv = [torch.from_numpy(onp.asarray(a.astype(jax.numpy.float32)))
                  .to(torch.bfloat16 if jd != jax.numpy.float32
                      else torch.float32) for a in (jw, jm, jv)]
    for t, lr in ((1, 1e-2), (2, 5e-3), (3, 3.7e-3)):
        g = (rs.randn(n) * 0.3).astype("float32")
        jg = jax.numpy.asarray(g).astype(jax.numpy.bfloat16 if half
                                         else jax.numpy.float32)
        if mode == "bf16_mp":
            jg = jg.astype(jax.numpy.float32)
        tg = torch.from_numpy(onp.asarray(jg.astype(jax.numpy.float32))) \
            .to(tw.dtype)
        jlr = jax.numpy.float32(lr).astype(jw.dtype)
        jw, jm, jv = jstep(jw, jg, jax.numpy.int32(t), jlr, jm, jv)
        got = tstep(tw, tg, t, lr, tm, tv)
        scale = torch.tensor(topt._fused_scale(_f32(lr), t, tw.dtype))
        again = tstep(tw, tg, None, None, tm, tv, scale=scale)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b in zip(got, (jw, jm, jv)):
            a = a.float().numpy()
            b = onp.asarray(b.astype(jax.numpy.float32))
            if mode == "bf16":
                assert _ulps(a, b) == 0
            else:
                # fp32: one element in a thousand may round the other way
                assert _ulps(a, b) <= 2
                assert (a != b).sum() <= n // 1000
        # the next step starts from the JAX package's values on both sides
        tw, tm, tv = [torch.from_numpy(onp.asarray(
            a.astype(jax.numpy.float32))).to(tw.dtype) for a in (jw, jm, jv)]


def _mlp(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=5),
                nn.Dense(3, in_units=8))
    return net


@pytest.fixture(scope="module")
def w0():
    rs = onp.random.RandomState(3)
    return {"0.weight": rs.randn(8, 5).astype("float32") * 0.5,
            "0.bias": rs.randn(8).astype("float32") * 0.1,
            "1.weight": rs.randn(3, 8).astype("float32") * 0.5,
            "1.bias": rs.randn(3).astype("float32") * 0.1}


def _batches(steps=4):
    rs = onp.random.RandomState(7)
    return [(rs.randn(6, 5).astype("float32"),
             rs.randint(0, 3, 6).astype("float32")) for _ in range(steps)]


def _adamw(pkg):
    sched = pkg.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    return pkg.optimizer.AdamW(learning_rate=1e-2, wd=0.01,
                               lr_scheduler=sched)


def _jax_dp(w0, dtype):
    net = _mlp(mx, "optdp_")
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p._data._data = jax.numpy.asarray(w0[k])   # uncommitted
    if dtype != "float32":
        net.cast(dtype)
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="optdpce_")
    step = mx.parallel.DataParallelStep(net, L, _adamw(mx), mesh=None)
    losses = [float(step(mx.nd.array(x).astype(dtype), mx.nd.array(y))
                    .astype("float32").asnumpy()) for x, y in _batches()]
    return losses, {k: p.data().astype("float32").asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}


def _port_dp(w0, dtype, mesh=None, shard=False):
    net = _mlp(mxt, "optdp_")
    net.initialize()
    load_jax_params(net, w0)
    if dtype != "float32":
        net.cast(dtype)
    L = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    step = mxt.parallel.DataParallelStep(net, L, _adamw(mxt), mesh=mesh,
                                         shard_optimizer=shard)
    losses = [float(step(mxt.nd.array(x).astype(dtype), mxt.nd.array(y))
                    .astype("float32").asnumpy()) for x, y in _batches()]
    return losses, {k: p.data().astype("float32").asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}, \
        step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_data_parallel_step_matches_jax(dtype, w0):
    jl, jw = _jax_dp(w0, dtype)
    with mxt.cpu():
        tl, tw, step = _port_dp(w0, dtype)
    assert len(step._cache) == 1 and len(set(jl)) == len(jl)
    if dtype == "float32":
        onp.testing.assert_allclose(tl, jl, rtol=1e-5)
        for k in jw:
            onp.testing.assert_allclose(tw[k], jw[k], rtol=1e-5, atol=1e-6)
        return
    onp.testing.assert_allclose(tl, jl, rtol=2e-2)
    for k in jw:
        ulp = 2.0 ** (onp.floor(onp.log2(onp.abs(jw[k]).max())) - 7)
        assert onp.abs(tw[k] - jw[k]).max() <= 2 * ulp + 2 * 4 * 1e-2


def test_adamw_zero_one_gloo_rank_gives_the_replicated_bits(w0):
    import torch.distributed as dist
    with mxt.cpu():
        want_l, want_w, _ = _port_dp(w0, "bfloat16")
        mxt.parallel.initialize()
        try:
            mesh = mxt.parallel.device_mesh()
            got_l, got_w, step = _port_dp(w0, "bfloat16", mesh, True)
        finally:
            dist.destroy_process_group()
    assert all(step._shard_slots)
    assert got_l == want_l
    for k in want_w:
        onp.testing.assert_array_equal(got_w[k], want_w[k])


@pytest.mark.parametrize("name", [n for n in NEW_RULES if n != "adamw"])
def test_rules_without_a_step_raise_in_data_parallel_step(name, w0):
    with pytest.raises(NotImplementedError):
        mx.optimizer.create(name).make_step(0)
    with mxt.cpu():
        net = _mlp(mxt, "optraise_")
        net.initialize()
        load_jax_params(net, w0)
        with pytest.raises(NotImplementedError, match="no jit-pure step"):
            mxt.parallel.DataParallelStep(
                net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                mxt.optimizer.create(name))


TRAINER_KW = {"signum": dict(learning_rate=0.01, wd=1e-3),
              "ftml": dict(learning_rate=0.01, wd=1e-3),
              "lbsgd": dict(momentum=0.9, learning_rate=0.1,
                            warmup_epochs=1, updates_per_epoch=2,
                            batch_scale=2),
              "dcasgd": dict(learning_rate=0.1, momentum=0.9),
              "adamw": dict(learning_rate=0.01, wd=0.01),
              "adagrad": dict(learning_rate=0.1),
              "rmsprop": dict(learning_rate=0.01, centered=True),
              "adadelta": dict(),
              "ftrl": dict(learning_rate=0.1),
              "adamax": dict(),
              "nadam": dict(learning_rate=0.01),
              "test": dict()}


def _jax_net(w0):
    net = _mlp(mx, "opttr_")
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(w0[k]))
    return net


def _port_net(w0):
    net = _mlp(mxt, "opttr_")
    net.initialize(ctx=mxt.cpu())
    load_jax_params(net, w0)
    return net


def _train(pkg, net, trainer, batches):
    kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in batches:
        with pkg.autograd.record():
            loss = L(net(pkg.nd.array(x, **kw)), pkg.nd.array(y, **kw))
        loss.backward()
        trainer.step(x.shape[0])


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _close(got, want):
    for k in want:
        onp.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                    err_msg=k)


@pytest.mark.parametrize("name", sorted(TRAINER_KW))
def test_trainer_and_states_files_cross_between_packages(name, w0,
                                                         tmp_path):
    """Two Trainer steps in each package, the same weights; the JAX
    package's states file read by the port, one step each; the port's
    file read by the JAX package, one step each."""
    kw = TRAINER_KW[name]
    batches = _batches(4)
    jnet = _jax_net(w0)
    jtr = mx.gluon.Trainer(jnet.collect_params(), name, dict(kw))
    _train(mx, jnet, jtr, batches[:2])
    tnet = _port_net(w0)
    ttr = mxt.gluon.Trainer(tnet.collect_params(), name, dict(kw))
    _train(mxt, tnet, ttr, batches[:2])
    _close(_weights(tnet), _weights(jnet))

    jfile = str(tmp_path / "jax.states")
    jtr.save_states(jfile)
    tnet2 = _port_net(_weights(jnet))
    ttr2 = mxt.gluon.Trainer(tnet2.collect_params(), name, dict(kw))
    ttr2.load_states(jfile)
    assert type(ttr2.optimizer).__name__ == type(jtr.optimizer).__name__
    assert ttr2.optimizer.num_update == jtr.optimizer.num_update
    if name == "nadam":
        assert ttr2.optimizer.m_schedule == jtr.optimizer.m_schedule
    _train(mx, jnet, jtr, batches[2:3])
    _train(mxt, tnet2, ttr2, batches[2:3])
    _close(_weights(tnet2), _weights(jnet))

    tfile = str(tmp_path / "port.states")
    ttr2.save_states(tfile)
    jnet2 = _jax_net(_weights(tnet2))
    jtr2 = mx.gluon.Trainer(jnet2.collect_params(), name, dict(kw))
    jtr2.load_states(tfile)
    assert type(jtr2.optimizer) is type(jtr.optimizer)
    assert jtr2.optimizer.num_update == ttr2.optimizer.num_update
    _train(mx, jnet2, jtr2, batches[3:])
    _train(mxt, tnet2, ttr2, batches[3:])
    _close(_weights(tnet2), _weights(jnet2))


def test_sgld_states_files_cross_between_packages(w0, tmp_path):
    """SGLD's noise cannot match, so its files are held by what they
    carry: the rule, its rate and its clock, each way."""
    batches = _batches(2)
    jnet = _jax_net(w0)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgld",
                           {"learning_rate": 1e-3})
    _train(mx, jnet, jtr, batches[:1])
    jfile = str(tmp_path / "jax.states")
    jtr.save_states(jfile)
    tnet = _port_net(w0)
    ttr = mxt.gluon.Trainer(tnet.collect_params(), "sgld",
                            {"learning_rate": 1e-3})
    ttr.load_states(jfile)
    assert type(ttr.optimizer) is mxt.optimizer.SGLD
    assert (ttr.optimizer.lr, ttr.optimizer.num_update) == (1e-3, 1)
    _train(mxt, tnet, ttr, batches[1:])
    tfile = str(tmp_path / "port.states")
    ttr.save_states(tfile)
    jtr2 = mx.gluon.Trainer(_jax_net(w0).collect_params(), "sgld",
                            {"learning_rate": 1e-3})
    jtr2.load_states(tfile)
    assert type(jtr2.optimizer) is mx.optimizer.SGLD
    assert jtr2.optimizer.num_update == 2
