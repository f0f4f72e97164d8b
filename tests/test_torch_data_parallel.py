"""Port parity: ``parallel.DataParallelStep`` over 2 gloo ranks against the
JAX package's ``DataParallelStep`` on a 2-device CPU mesh, from the same
weights and data.

The module spawns its 2 ranks once (``torch.multiprocessing``, a
``localhost`` rendezvous, the ``MXNET_TPU_*`` launcher environment, so
each rank joins at ``import mxnet_tpu_torch``); each rank runs every case
on the CPU and writes what it ends with, and the tests compare that with
the JAX step.  The ranks import neither JAX nor the JAX package: this
file imports them only inside the tests.

Cases and tolerances:

* ``mlp``: Dense(7, tanh) and Dense(3) (odd sizes, so the ZeRO layout
  pads), SGD with momentum, 4 steps, float32: weights within rtol 1e-5,
  atol 1e-6 (the gradient summed over the ranks in another order);
* ``sched``: the same net under SGD with weight decay and a
  ``FactorScheduler`` halving the rate each step: the same tolerance, and
  the losses within rtol 1e-5;
* ``zero``: Adam with ``shard_optimizer=True``: each rank's shard of every
  state leaf against the JAX shard (rtol 1e-5, atol 1e-7), and the port's
  sharded weights equal, bit for bit, to its replicated run's (a sum of
  two values has one order);
* ``scan``: ``scan_steps`` over 3 steps equal, bit for bit, to 3 calls,
  and within rtol 1e-5, atol 1e-6 of the JAX package's calls;
* ``convbn``: Conv2D, BatchNorm, ReLU, global average pool and Dense:
  the statistics are the global batch's on both ranks, so the weights and
  the running mean and variance match the JAX step's within rtol 1e-4,
  atol 1e-5;
* ``bf16``: a transformer encoder layer at L = 128 (the (B, T, H, D)
  attention of rows 10-11, through their plain versions on the CPU) and a
  Dense head, bfloat16, valid lengths, Adam, 2 steps: the losses within
  rel 2e-2; each parameter's Adam moments within a relative L2 error of
  3 bf16 ulps (3 * 2^-7); each weight within 2 bf16 ulps of its largest
  entry plus 2 * lr a step (Adam moves an element about lr a step, so an
  element whose gradient is near 0 may go either way), and all the
  updates together within a relative L2 error of 0.1.
"""
import multiprocessing
import os
import socket
import traceback

import numpy as onp
import pytest
import torch

WORLD = 2
MLP_X = (16, 5)
CONV_X = (8, 3, 6, 6)
SEQ, UNITS, HEADS, HEAD_OUT = 128, 32, 2, 8
BF16_LENS = (128, 100, 77, 128)
CASES = ("mlp", "sched", "zero", "zero_replicated", "scan", "convbn",
         "bf16")


# --------------------------------------------------------------------------
# nets and data, built the same way from either package
# --------------------------------------------------------------------------

def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="dpmlp_")
    with net.name_scope():
        net.add(nn.Dense(7, activation="tanh", in_units=5),
                nn.Dense(3, in_units=7))
    return net


def _convbn(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="dpconv_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=4), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(3, in_units=4))
    return net


def _encoder(pkg):
    gluon = pkg.gluon

    class Encoder(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = gluon.contrib.nn.TransformerEncoderCell(
                    UNITS, 2 * UNITS, HEADS, prefix="cell_")
                self.head = gluon.nn.Dense(HEAD_OUT, flatten=False,
                                           prefix="head_")

        def hybrid_forward(self, F, x, valid_length):
            return self.head(self.cell(x, None, valid_length))
    return Encoder(prefix="dpenc_")


def _net(pkg, case):
    if case == "convbn":
        return _convbn(pkg)
    if case == "bf16":
        return _encoder(pkg)
    return _mlp(pkg)


# the replicated run of the "zero" case starts where it starts
_START = {"zero_replicated": "zero"}


def _data(case):
    """The global batch(es) of ``case``, numpy, from a fixed seed."""
    rs = onp.random.RandomState(CASES.index(_START.get(case, case)) + 11)
    if case == "convbn":
        x = rs.randn(3, *CONV_X).astype("float32")
        return x, rs.randint(0, 3, (3, CONV_X[0])).astype("float32")
    if case == "bf16":
        x = (rs.randn(2, 4, SEQ, UNITS) * 0.5).astype("float32")
        y = rs.randn(2, 4, SEQ, HEAD_OUT).astype("float32")
        return x, y
    x = rs.randn(4, *MLP_X).astype("float32")
    return x, rs.randint(0, 3, (4, MLP_X[0])).astype("float32")


def _optimizer(pkg, case):
    if case == "sched":
        return pkg.optimizer.SGD(
            learning_rate=0.4, wd=1e-3,
            lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=1,
                                                          factor=0.5))
    if case in ("zero", "zero_replicated"):
        return pkg.optimizer.Adam(learning_rate=0.02)
    if case == "bf16":
        return pkg.optimizer.Adam(learning_rate=BF16_LR)
    return pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9)


BF16_LR = 1e-2


def _loss(pkg, case):
    if case == "bf16":
        return pkg.gluon.loss.L2Loss()
    return pkg.gluon.loss.SoftmaxCrossEntropyLoss()


def _settle(pkg, net, case, ctx):
    """One forward, so that deferred shapes are known (the encoder)."""
    if case == "bf16":
        x, _ = _data(case)
        net(pkg.nd.array(x[0], ctx=ctx),
            pkg.nd.array(onp.array(BF16_LENS, "int32"), ctx=ctx,
                         dtype="int32"))


def _run(pkg, case, net, mesh, ctx):
    """Train ``net`` through ``pkg``'s DataParallelStep; the losses and the
    step."""
    L = _loss(pkg, case)
    step = pkg.parallel.DataParallelStep(
        net, lambda o, l: L(o, l), _optimizer(pkg, case), mesh=mesh,
        shard_optimizer=(case == "zero"))
    x, y = _data(case)
    nd = pkg.nd
    if case == "bf16":
        vl = nd.array(onp.array(BF16_LENS, "int32"), ctx=ctx, dtype="int32")
        losses = [step((nd.array(xx, ctx=ctx).astype("bfloat16"), vl),
                       nd.array(yy, ctx=ctx).astype("bfloat16"))
                  for xx, yy in zip(x, y)]
        losses = [float(v.astype("float32").asnumpy()) for v in losses]
    elif case == "scan":
        losses = list(step.scan_steps(nd.array(x[:3], ctx=ctx),
                                      nd.array(y[:3], ctx=ctx)).asnumpy())
    else:
        losses = [float(step(nd.array(xx, ctx=ctx),
                             nd.array(yy, ctx=ctx)).asnumpy())
                  for xx, yy in zip(x, y)]
    return onp.asarray(losses, "float32"), step


def _arrays(net):
    return {k: p.data().astype("float32").asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _state_shards(net, step):
    """Each trainable parameter's optimizer-state leaves, by structural
    name, as numpy."""
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    out = {}
    for slot, i in enumerate(step._trainable):
        for j, leaf in enumerate(step._opt_states[slot]):
            leaf = leaf._data if hasattr(leaf, "_data") else leaf
            out["%s/%d" % (names[id(step._params[i])], j)] = onp.asarray(
                leaf.float() if hasattr(leaf, "float") else leaf,
                "float32")
    return out


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, out_dir):
    """A rank's process: it joined the group when it imported the port
    (the launcher environment); run ``fn`` and record a failure."""
    try:
        import mxnet_tpu_torch as mxt
        import torch.distributed as dist
        torch.set_num_threads(2)
        assert dist.is_initialized() and dist.get_world_size() == WORLD
        fn(mxt, rank, out_dir)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn, out_dir, timeout=120):
    """Run ``fn(mxt, rank, out_dir)`` in ``WORLD`` spawned gloo ranks;
    raise with their tracebacks if any fails or hangs."""
    ctx = multiprocessing.get_context("spawn")
    env = {"MXNET_TPU_COORDINATOR_ADDRESS": "localhost:%d" % _free_port(),
           "MXNET_TPU_NUM_PROCESSES": str(WORLD),
           "MXNET_TPU_DIST_BACKEND": "gloo", "MXNET_TPU_INIT_TIMEOUT": "60"}
    procs = []
    saved = {k: os.environ.get(k) for k in list(env) + ["MXNET_TPU_PROCESS_ID"]}
    try:
        for rank in range(WORLD):
            os.environ.update(env, MXNET_TPU_PROCESS_ID=str(rank))
            p = ctx.Process(target=_rank_main, args=(fn, rank, out_dir))
            p.start()
            procs.append(p)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for p in procs:
        p.join(timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = []
    for rank in range(WORLD):
        path = os.path.join(out_dir, "rank%d.err" % rank)
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f.read())
    if hung or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError("ranks failed (exit codes %s, %d hung):\n%s" % (
            [p.exitcode for p in procs], len(hung), "\n".join(errs)))


def _dp_worker(mxt, rank, out_dir):
    mesh = mxt.parallel.device_mesh((WORLD,), ("dp",))
    init = dict(onp.load(os.path.join(out_dir, "init.npz")))
    with mxt.cpu():
        for case in CASES:
            net = _net(mxt, case)
            net.initialize()
            _settle(mxt, net, case, mxt.cpu())
            prefix = _START.get(case, case) + "/"
            mxt.gluon.utils.load_jax_params(
                net, {k[len(prefix):]: v for k, v in init.items()
                      if k.startswith(prefix)})
            if case == "bf16":
                net.cast("bfloat16")
            losses, step = _run(mxt, case, net, mesh, mxt.cpu())
            res = {"losses": losses, "state_bytes":
                   onp.array([step.optimizer_state_bytes(True),
                              step.optimizer_state_bytes(False)])}
            res.update({"w/" + k: v for k, v in _arrays(net).items()})
            res.update({"s/" + k: v
                        for k, v in _state_shards(net, step).items()})
            if case == "scan":
                # the same steps again, one call each, from the same start
                again = _net(mxt, case)
                again.initialize()
                mxt.gluon.utils.load_jax_params(
                    again, {k[len(prefix):]: v for k, v in init.items()
                            if k.startswith(prefix)})
                L = _loss(mxt, case)
                st = mxt.parallel.DataParallelStep(
                    again, lambda o, l: L(o, l), _optimizer(mxt, case),
                    mesh=mesh)
                x, y = _data(case)
                res["call_losses"] = onp.array(
                    [float(st(mxt.nd.array(xx), mxt.nd.array(yy)).asnumpy())
                     for xx, yy in zip(x[:3], y[:3])], "float32")
                res.update({"c/" + k: v for k, v in _arrays(again).items()})
            onp.savez(os.path.join(out_dir, "%s_%d.npz" % (case, rank)),
                      **res)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The initial weights (from the port, on the CPU, seeded), then both
    ranks' results for every case, by case and rank."""
    import mxnet_tpu_torch as mxt
    out = str(tmp_path_factory.mktemp("dp_ranks"))
    init = {}
    mxt.random.seed(5)
    with mxt.cpu():
        for case in CASES:
            net = _net(mxt, case)
            net.initialize(mxt.init.Xavier())
            _settle(mxt, net, case, mxt.cpu())
            init.update({"%s/%s" % (case, k): v
                         for k, v in _arrays(net).items()})
    onp.savez(os.path.join(out, "init.npz"), **init)
    spawn_ranks(_dp_worker, out)
    res = {case: [dict(onp.load(os.path.join(out, "%s_%d.npz" % (case, r))))
                  for r in range(WORLD)] for case in CASES}
    return init, res


def _jax_run(case, init):
    """The same case through the JAX package's DataParallelStep on a
    2-device mesh: the losses, the weights and the state, by name."""
    import jax
    import mxnet_tpu as mx
    mesh = mx.parallel.device_mesh((WORLD,), ("dp",),
                                   devices=jax.devices()[:WORLD])
    net = _net(mx, case)
    net.initialize()
    _settle(mx, net, case, mx.cpu())
    prefix = case + "/"
    for k, p in net._collect_params_with_prefix().items():
        # uncommitted, as initialize() leaves them: the step places them
        p._data._data = jax.numpy.asarray(init[prefix + k])
    if case == "bf16":
        net.cast("bfloat16")
    losses, step = _run(mx, case, net, mesh, mx.cpu())
    return losses, _arrays(net), _state_shards(net, step), step


def _weights(res):
    return {k[2:]: v for k, v in res.items() if k.startswith("w/")}


def _same_on_every_rank(results, prefix="w/"):
    for k, v in results[0].items():
        if k.startswith(prefix):
            onp.testing.assert_array_equal(results[1][k], v, err_msg=k)


@pytest.mark.parametrize("case", ["mlp", "sched"])
def test_replicated_sgd_matches_jax_two_devices(ranks, case):
    init, res = ranks
    losses, jw, _, _ = _jax_run(case, init)
    _same_on_every_rank(res[case])
    onp.testing.assert_allclose(res[case][0]["losses"], losses, rtol=1e-5)
    got = _weights(res[case][0])
    assert set(got) == set(jw)
    for k in jw:
        onp.testing.assert_allclose(got[k], jw[k], rtol=1e-5, atol=1e-6,
                                    err_msg=k)
        assert not onp.array_equal(got[k], init[case + "/" + k]), k


def test_zero_shards_match_jax_shards(ranks):
    init, res = ranks
    losses, jw, jstate, jstep = _jax_run("zero", init)
    onp.testing.assert_allclose(res["zero"][0]["losses"], losses, rtol=1e-5)
    _same_on_every_rank(res["zero"])
    got = _weights(res["zero"][0])
    for k in jw:
        onp.testing.assert_allclose(got[k], jw[k], rtol=1e-5, atol=1e-6,
                                    err_msg=k)
    # the sharded update and the replicated one: the same bits
    rep = _weights(res["zero_replicated"][0])
    for k in got:
        onp.testing.assert_array_equal(got[k], rep[k], err_msg=k)
    # rank r holds elements r P / N to (r + 1) P / N of each padded leaf
    shards = {k[2:] for k in res["zero"][0] if k.startswith("s/")}
    assert shards == set(jstate) and len(shards) == 2 * len(jw)
    padded = False
    for k, full in jstate.items():
        n = full.shape[0] // WORLD
        assert full.ndim == 1 and full.shape[0] % WORLD == 0, k
        padded |= full.shape[0] != init["zero/" + k.split("/")[0]].size
        for r in range(WORLD):
            onp.testing.assert_allclose(
                res["zero"][r]["s/" + k], full[r * n:(r + 1) * n],
                rtol=1e-5, atol=1e-7, err_msg="%s rank %d" % (k, r))
    assert padded
    want = (jstep.optimizer_state_bytes(True),
            jstep.optimizer_state_bytes(False))
    assert tuple(res["zero"][0]["state_bytes"]) == want


def test_scan_steps_equals_calls_and_matches_jax(ranks):
    init, res = ranks
    r0 = res["scan"][0]
    onp.testing.assert_array_equal(r0["losses"], r0["call_losses"])
    for k, v in _weights(r0).items():
        onp.testing.assert_array_equal(v, r0["c/" + k], err_msg=k)
    losses, jw, _, _ = _jax_run("scan", init)
    onp.testing.assert_allclose(r0["call_losses"], losses[:3], rtol=1e-5)


def test_batchnorm_takes_global_batch_statistics(ranks):
    init, res = ranks
    losses, jw, _, _ = _jax_run("convbn", init)
    _same_on_every_rank(res["convbn"])
    onp.testing.assert_allclose(res["convbn"][0]["losses"], losses,
                                rtol=1e-4)
    got = _weights(res["convbn"][0])
    stats = [k for k in jw if "running" in k]
    assert len(stats) == 2
    for k in jw:
        onp.testing.assert_allclose(got[k], jw[k], rtol=1e-4, atol=1e-5,
                                    err_msg=k)
        assert not onp.array_equal(got[k], init["convbn/" + k]), k


def test_bf16_transformer_layer_matches_jax(ranks):
    init, res = ranks
    losses, jw, jstate, _ = _jax_run("bf16", init)
    _same_on_every_rank(res["bf16"])
    r0 = res["bf16"][0]
    onp.testing.assert_allclose(r0["losses"], losses, rtol=2e-2)
    got = _weights(r0)
    assert set(got) == set(jw)
    steps = len(losses)
    num = den = 0.0
    for k in jw:
        # Adam's moments carry the gradients: within 3 bf16 ulps (2^-7
        # relative) in relative L2
        for j in (0, 1):
            a, b = r0["s/%s/%d" % (k, j)], jstate["%s/%d" % (k, j)]
            err = onp.linalg.norm(a - b) / onp.linalg.norm(b)
            assert err <= 3 * 2.0 ** -7, (k, j, err)
        # Adam moves an element by about lr a step whatever its gradient,
        # so a gradient near 0 may move it either way in either package
        ulp = 2.0 ** (onp.floor(onp.log2(onp.abs(jw[k]).max())) - 7)
        assert onp.abs(got[k] - jw[k]).max() <= 2 * ulp + 2 * steps * BF16_LR
        w0 = init["bf16/" + k]
        num += float(onp.square(got[k] - jw[k]).sum())
        den += float(onp.square(jw[k] - w0).sum())
    assert (num / den) ** 0.5 <= 0.1


def test_waiting_knobs_raise_naming_the_roadmap():
    """The knobs that wait raise instead of being ignored."""
    import mxnet_tpu_torch as mxt
    with mxt.cpu():
        net = _mlp(mxt)
        net.initialize()
        L = mxt.gluon.loss.L2Loss()
        for kw in ({"mirror": "mirror"}, {"donate_batch": True},
                   {"grad_compression": "int8"}):
            with pytest.raises(mxt.MXNetError, match="ROADMAP"):
                mxt.parallel.DataParallelStep(net, L, mxt.optimizer.SGD(),
                                              **kw)
        step = mxt.parallel.DataParallelStep(net, L, mxt.optimizer.SGD())
        for call in (lambda: step.reshard(None), step.checkpoint_state,
                     lambda: step.load_checkpoint_state({})):
            with pytest.raises(mxt.MXNetError, match="ROADMAP"):
                call()
        with pytest.raises(NotImplementedError):
            mxt.parallel.DataParallelStep(
                net, L, mxt.optimizer.NAG(momentum=0.9))


def test_dropout_draws_a_generator_a_step_from_mx_random():
    """Dropout inside the step draws from the step's generator, seeded
    from ``mx.random`` at the first call and after each ``mx.random.seed``
    and advanced by every step: the same seed gives the same steps, and
    the next step draws another mask."""
    import mxnet_tpu_torch as mxt
    nn = mxt.gluon.nn
    x = onp.random.RandomState(0).randn(8, 5).astype("float32")
    y = onp.random.RandomState(1).randn(8, 5).astype("float32")

    def losses():
        net = nn.HybridSequential(prefix="dpdrop_")
        with net.name_scope():
            net.add(nn.Dense(16, in_units=5), nn.Dropout(0.5),
                    nn.Dense(5, in_units=16))
        net.initialize(mxt.init.One())
        mxt.random.seed(3)
        L = mxt.gluon.loss.L2Loss()
        step = mxt.parallel.DataParallelStep(
            net, lambda o, l: L(o, l), mxt.optimizer.SGD(learning_rate=0.0))
        return [float(step(x, y).asnumpy()) for _ in range(3)]
    with mxt.cpu():
        first, again = losses(), losses()
    assert first == again
    assert len(set(first)) == 3     # lr 0: only the masks differ
