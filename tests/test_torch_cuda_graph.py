"""Captured execution on the CPU: the static-buffer protocol of
``mxnet_tpu_torch.cuda_graph`` without a graph (on the card each call after
the first replays one; ``tests/test_torch_cuda.py`` holds that there).

* ``DataParallelStep``, whose per-step rates and step count reach the
  update as device scales, against the JAX package's step for 4 steps
  under a ``FactorScheduler`` that changes the rate every step: SGD with
  momentum in float32 (weights within rtol 1e-5, atol 1e-6, losses rtol
  1e-5, as tests/test_torch_data_parallel.py) and Adam on bfloat16 weights
  and state (losses rtol 2e-2, each weight within 2 bf16 ulps of its
  largest entry plus 2 x steps x lr, as the bf16 case there);
* ``make_step`` given its scale as a device tensor gives the bits of the
  same step given ``t`` and ``lr`` as numbers, for SGD with and without
  momentum and Adam, float32, bfloat16 and bfloat16 with fp32 masters;
* the ZeRO branch on a one-rank gloo group writes its state in place and
  gives the bits of the replicated step (two ranks run in
  tests/test_torch_data_parallel.py through the same code);
* ``_CachedGraph``, as tests/test_gluon.py:96-169 hold the JAX package's:
  it matches eager and the JAX package's hybridized forward, BatchNorm's
  running statistics move, keyword arguments, a deferred first call and a
  child inside its parent's body run eagerly, a recorded forward is a
  captured pair (the eager gradient's bits; tests/test_torch_compiled_
  training.py holds it against the JAX package), ``cast`` and
  ``hybridize(False)`` drop the cache, and a replaced parameter tensor is
  captured again;
* outputs and losses are fresh tensors, never aliased across calls;
* ``AotModel`` refuses buckets and shapes outside its menu, and
  ``from_exported`` waits;
* ``telemetry.record_compile`` counts one capture a key on each path.
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import cuda_graph, telemetry
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.serve import AotModel

STEPS = 4
F32 = dict(rtol=1e-5, atol=1e-6)
ADAM_LR = 1e-2
X_SHAPE, N_OUT = (6, 5), 3


def _mlp(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=X_SHAPE[1]),
                nn.Dense(N_OUT, in_units=8))
    return net


def _optimizer(pkg, case):
    sched = pkg.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    if case == "adam_bf16":
        return pkg.optimizer.Adam(learning_rate=ADAM_LR, lr_scheduler=sched)
    return pkg.optimizer.SGD(learning_rate=0.2, momentum=0.9, wd=1e-3,
                             lr_scheduler=sched)


def _batches():
    rs = onp.random.RandomState(7)
    return [(rs.randn(*X_SHAPE).astype("float32"),
             rs.randint(0, N_OUT, X_SHAPE[0]).astype("float32"))
            for _ in range(STEPS)]


def _jax_run(case, w0):
    net = _mlp(mx, "cgmlp_")
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p._data._data = jax.numpy.asarray(w0[k])   # uncommitted
    if case == "adam_bf16":
        net.cast("bfloat16")
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="cgce_")
    step = mx.parallel.DataParallelStep(net, L, _optimizer(mx, case),
                                        mesh=None)
    dtype = "bfloat16" if case == "adam_bf16" else "float32"
    losses = [float(step(mx.nd.array(x).astype(dtype), mx.nd.array(y))
                    .astype("float32").asnumpy()) for x, y in _batches()]
    return losses, {k: p.data().astype("float32").asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}


def _port_run(case, w0):
    with mxt.cpu():
        net = _mlp(mxt, "cgmlp_")
        net.initialize()
        load_jax_params(net, w0)
        if case == "adam_bf16":
            net.cast("bfloat16")
        L = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        step = mxt.parallel.DataParallelStep(net, L, _optimizer(mxt, case),
                                             mesh=None)
        dtype = "bfloat16" if case == "adam_bf16" else "float32"
        losses = [step(mxt.nd.array(x).astype(dtype), mxt.nd.array(y))
                  for x, y in _batches()]
    return ([float(v.astype("float32").asnumpy()) for v in losses],
            {k: p.data().astype("float32").asnumpy()
             for k, p in net._collect_params_with_prefix().items()}, step)


@pytest.fixture(scope="module")
def w0():
    rs = onp.random.RandomState(3)
    return {"0.weight": rs.randn(8, X_SHAPE[1]).astype("float32") * 0.5,
            "0.bias": rs.randn(8).astype("float32") * 0.1,
            "1.weight": rs.randn(N_OUT, 8).astype("float32") * 0.5,
            "1.bias": rs.randn(N_OUT).astype("float32") * 0.1}


@pytest.mark.parametrize("case", ["sgd_momentum", "adam_bf16"])
def test_step_with_device_scales_matches_jax_under_a_schedule(case, w0):
    jl, jw = _jax_run(case, w0)
    tl, tw, step = _port_run(case, w0)
    assert len(set(jl)) == STEPS
    # one key, one capture: the rate moved every step through the scales
    assert len(step._cache) == 1
    if case == "sgd_momentum":
        onp.testing.assert_allclose(tl, jl, rtol=1e-5)
        for k in jw:
            onp.testing.assert_allclose(tw[k], jw[k], err_msg=k, **F32)
            assert not onp.array_equal(tw[k], w0[k]), k
        return
    onp.testing.assert_allclose(tl, jl, rtol=2e-2)
    for k in jw:
        ulp = 2.0 ** (onp.floor(onp.log2(onp.abs(jw[k]).max())) - 7)
        assert onp.abs(tw[k] - jw[k]).max() <= 2 * ulp + 2 * STEPS * ADAM_LR


OPTS = [("sgd", dict(learning_rate=0.1, wd=1e-4, rescale_grad=0.5)),
        ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
        ("adam", dict(learning_rate=1e-3, wd=1e-4, rescale_grad=0.5))]


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_mp"])
@pytest.mark.parametrize("opt", OPTS, ids=["sgd", "sgd_momentum", "adam"])
def test_device_scale_gives_the_bits_of_host_numbers(opt, mode):
    name, kw = opt
    o = mxt.optimizer.create(name, multi_precision=mode == "bf16_mp", **kw)
    rs = onp.random.RandomState(1)
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    w = torch.from_numpy(rs.randn(1031).astype("float32")).to(dtype)
    g = torch.from_numpy(rs.randn(1031).astype("float32")).to(dtype)
    state = mxt.optimizer.optimizer._leaves(o.create_state_multi_precision(
        0, mxt.nd.array(w, ctx=mxt.cpu(), dtype=w.dtype)))
    if mode == "bf16_mp":
        w, g, state = state[0], g.float(), state[1:]
    step = o.make_step(0)
    for t, lr in ((1, 0.1), (2, 0.05), (7, 0.0371)):
        want = step(w, g, t, lr, *state)
        scale = torch.tensor(o._fused_scale(mxt.optimizer.optimizer._f32(lr),
                                            t, w.dtype))
        got = step(w, g, None, None, *state, scale=scale)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        w, state = want[0], list(want[1:])


def test_zero_state_is_written_in_place_one_gloo_rank(w0):
    """ZeRO's branch on a one-rank gloo group: the state leaves keep their
    addresses (a captured step reads them there) and the step gives the
    bits of the replicated one."""
    import torch.distributed as dist

    def run(mesh, shard):
        net = _mlp(mxt, "cgzero_")
        net.initialize()
        load_jax_params(net, w0)
        L = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        step = mxt.parallel.DataParallelStep(
            net, L, _optimizer(mxt, "adam_bf16"), mesh=mesh,
            shard_optimizer=shard)
        ptrs = [[leaf.data_ptr() for leaf in leaves]
                for leaves in step._opt_states]
        losses = [step(x, y).asnumpy() for x, y in _batches()]
        assert ptrs == [[leaf.data_ptr() for leaf in leaves]
                        for leaves in step._opt_states]
        return losses, [p.data().asnumpy()
                        for _, p in sorted(net.collect_params().items())], \
            step
    with mxt.cpu():
        want_l, want_w, _ = run(None, False)
        mxt.parallel.initialize()
        try:
            mesh = mxt.parallel.device_mesh()
            got_l, got_w, step = run(mesh, True)
        finally:
            dist.destroy_process_group()
    assert all(step._shard_slots)
    onp.testing.assert_array_equal(onp.array(got_l), onp.array(want_l))
    for a, b in zip(got_w, want_w):
        onp.testing.assert_array_equal(a, b)


def test_step_reports_one_capture_a_key_and_returns_fresh_losses(w0):
    with mxt.cpu():
        net = _mlp(mxt, "cgkey_")
        net.initialize()
        load_jax_params(net, w0)
        L = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        step = mxt.parallel.DataParallelStep(
            net, L, mxt.optimizer.SGD(learning_rate=0.1), mesh=None)
        fn = "DataParallelStep[%x]" % id(step)
        (x, y), (x2, y2) = _batches()[:2]
        first = step(x, y)
        kept = first.asnumpy().copy()
        second = step(x2, y2)
        assert telemetry.compile_counts()[fn] == 1
        assert first.astorch().data_ptr() != second.astorch().data_ptr()
        onp.testing.assert_array_equal(first.asnumpy(), kept)
        step(onp.concatenate([x, x]), onp.concatenate([y, y]))
        assert telemetry.compile_counts()[fn] == 2       # a new batch shape
        step.scan_steps(onp.stack([x, x2]), onp.stack([y, y2]))
        assert telemetry.compile_counts()[fn] == 3       # scan is its own key
        p = net.collect_params()[sorted(net.collect_params().keys())[0]]
        p._data._data = p._data._data.detach().clone().requires_grad_()
        step(x, y)
        assert telemetry.compile_counts()[fn] == 4       # a swapped weight
        step(x, y)
        assert telemetry.compile_counts()[fn] == 4
        assert len(step._cache) == 3


def test_eager_run_of_the_step_body_is_the_graph_protocol(w0):
    """``_run_eagerly`` (what a replay is held to on the card) runs the
    same body on the same buffers: the same bits as the call."""
    def run(eager):
        with mxt.cpu():
            net = _mlp(mxt, "cgeager_")
            net.initialize()
            load_jax_params(net, w0)
            step = mxt.parallel.DataParallelStep(
                net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                _optimizer(mxt, "sgd_momentum"), mesh=None)
            call = step._run_eagerly if eager else step
            return [call(x, y).asnumpy() for x, y in _batches()]
    assert onp.array_equal(run(True), run(False))


# -- _CachedGraph ------------------------------------------------------------

def _hybrid_pair(seed=0):
    """The same Dense/BatchNorm net in both packages, same weights."""
    rs = onp.random.RandomState(seed)
    x = rs.randn(5, 7).astype("float32")

    def build(pkg):
        nn = pkg.gluon.nn
        net = nn.HybridSequential(prefix="cghyb_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="tanh", in_units=7),
                    nn.BatchNorm(in_channels=16), nn.Dense(3, in_units=16))
        return net
    jnet = build(mx)
    jnet.initialize(mx.init.Xavier())
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    with mxt.cpu():
        net = build(mxt)
        net.initialize()
        load_jax_params(net, arrays)
    return jnet, net, x


def test_hybridize_matches_eager_and_the_jax_package():
    jnet, net, x = _hybrid_pair()
    with mxt.cpu():
        eager = net(mxt.nd.array(x)).asnumpy()
        net.hybridize()
        fn = "CachedOp_" + net.name
        n0 = telemetry.compile_counts().get(fn, 0)
        a = net(mxt.nd.array(x))
        b = net(mxt.nd.array(x))
        assert telemetry.compile_counts()[fn] == n0 + 1
        assert len(net._cached_graph._cache) == 1
        assert a.astorch().data_ptr() != b.astorch().data_ptr()
    jnet.hybridize()
    want = jnet(mx.nd.array(x)).asnumpy()
    onp.testing.assert_array_equal(a.asnumpy(), eager)
    onp.testing.assert_array_equal(b.asnumpy(), eager)
    onp.testing.assert_allclose(a.asnumpy(), want, rtol=1e-5, atol=1e-6)
    # a child inside its parent's body runs through
    assert all(c._cached_graph is None for c in net._children.values())


def test_hybridized_batchnorm_running_stats_move_as_jax():
    jnet, net, x = _hybrid_pair(1)
    jnet.hybridize()
    with mx.autograd.train_mode():
        for _ in range(2):
            jnet(mx.nd.array(x))
    with mxt.cpu():
        net.hybridize()
        with mxt.autograd.train_mode():
            for _ in range(2):
                net(mxt.nd.array(x))
        keys = [k for k in net._cached_graph._cache]
        assert keys and all(k[0] for k in keys)     # captured, training
    jbn, bn = jnet[1], net[1]
    for name in ("running_mean", "running_var"):
        got = getattr(bn, name).data().asnumpy()
        onp.testing.assert_allclose(got, getattr(jbn, name).data().asnumpy(),
                                    rtol=1e-5, atol=1e-6)
    assert not (bn.running_mean.data().asnumpy() == 0).all()


def test_kwargs_deferred_recorded_calls_run_eagerly_and_cache_drops():
    with mxt.cpu():
        nn = mxt.gluon.nn
        net = nn.HybridSequential(prefix="cgdef_")
        with net.name_scope():
            net.add(nn.Dense(4), nn.Dense(2))
        net.initialize()
        net.hybridize()
        x = mxt.nd.array(onp.ones((3, 5), "float32"))
        net(x)                                   # completes deferred shapes
        assert net._cached_graph is None
        with mxt.autograd.record():
            y = net(x)
        y.backward()                             # the captured pair
        (key, (rec, _)), = net._cached_graph._cache.items()
        assert key[:2] == (True, True)           # training, recording
        assert len(rec.pairs) == 1 and not rec.pairs[0].busy
        graphed = net[0].weight.grad().asnumpy()
        net.hybridize(False)
        with mxt.autograd.record():
            y = net(x)
        y.backward()                             # eager: the same gradient
        assert onp.array_equal(net[0].weight.grad().asnumpy(), graphed)
        net.hybridize()
        assert net._cached_graph is None
        dense = net[0]
        dense.hybridize()
        with pytest.raises(TypeError):
            dense(x, bogus=1)                    # kwargs: eager, as called
        assert dense._cached_graph is None
        net(x)
        assert len(net._cached_graph._cache) == 1
        net.cast("float32")
        assert net._cached_graph is None
        net(x)
        net.hybridize(False)
        assert net._cached_graph is None
        net.hybridize()
        out = net(x)
        # a replaced parameter tensor is captured again (a recompile)
        fn = "CachedOp_" + net.name
        n = telemetry.compile_counts()[fn]
        p = dense.weight
        p._data._data = p._data._data.detach() * 2
        twice = net(x)
        assert telemetry.compile_counts()[fn] == n + 1
        assert len(net._cached_graph._cache) == 1
        assert not onp.array_equal(out.asnumpy(), twice.asnumpy())


def test_capturing_flag_is_set_inside_a_body_only():
    seen = []
    graph = cuda_graph.Captured(lambda ins: seen.append(
        cuda_graph.capturing()) or [ins[0] + 1], [torch.zeros(2)])
    assert not cuda_graph.capturing()
    out = graph([torch.ones(2)])
    assert seen == [True] and not cuda_graph.capturing()
    assert torch.equal(out[0], torch.full((2,), 2.0))
    assert out[0].data_ptr() != graph.inputs[0].data_ptr()


def test_launch_credit_round_trip():
    from mxnet_tpu_torch.ops import layernorm
    before = cuda_graph._launch_counts()
    cuda_graph._add_launches({("layernorm", "BWD_LAUNCHES"): 3})
    assert layernorm.BWD_LAUNCHES == before["layernorm", "BWD_LAUNCHES"] + 3
    cuda_graph._add_launches({("layernorm", "BWD_LAUNCHES"): -3})
    assert cuda_graph._launch_counts() == before


# -- AotModel ----------------------------------------------------------------

def test_aot_model_refuses_unknown_buckets_and_shapes():
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    model = AotModel(lambda x: x @ w, feature_shape=(4,), ctx=mxt.cpu(),
                     name="cgaot")
    model.compile_all([1, 4, 2])
    assert model.buckets == [1, 2, 4]
    counts = telemetry.compile_counts()
    assert all(counts["serve.cgaot.b%d" % b] == 1 for b in (1, 2, 4))
    model.compile_all([4])                       # idempotent
    assert telemetry.compile_counts()["serve.cgaot.b4"] == 1
    x = onp.ones((2, 4), "float32")
    a, b = model.run(2, x), model.run(2, x)
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with pytest.raises(mxt.MXNetError, match="never captured"):
        model.run(3, onp.ones((3, 4), "float32"))
    with pytest.raises(mxt.MXNetError, match="batch shape"):
        model.run(2, onp.ones((4, 4), "float32"))
    with pytest.raises(mxt.MXNetError, match="waits"):
        AotModel.from_exported("artifact")


def test_server_quarantines_a_bucket_whose_graph_fails():
    """A bucket's graph that raises is retried, quarantined, and its
    batch re-planned onto the smaller buckets' graphs."""
    from mxnet_tpu_torch import serve
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    model = AotModel(lambda x: x @ w, feature_shape=(4,), ctx=mxt.cpu(),
                     name="cgsrv")
    srv = serve.InferenceServer(model, config=serve.ServeConfig(
        buckets=(1, 2, 4), max_queue=16, batch_wait_ms=50.0,
        max_retries=1, default_deadline_ms=2000.0,
        dispatch_timeout_ms=2000.0, watchdog_interval_ms=15.0))
    srv.start()

    def broken(inputs):
        raise RuntimeError("graph replay failed")
    model._graphs[4] = broken
    try:
        rows = [onp.full((4,), i, "float32") for i in range(4)]
        outs = [h.outcome(timeout=5.0) for h in [srv.submit(r)
                                                 for r in rows]]
        assert all(o is not None and o[0] == "result" for o in outs), outs
        for r, o in zip(rows, outs):
            onp.testing.assert_array_equal(o[1], (torch.from_numpy(r) @ w)
                                           .numpy())
        assert srv.stats()["quarantined"] == [4]
        assert srv.state() == serve.DEGRADED
        assert srv.steady_state_recompiles() == {}
    finally:
        srv.close()
