"""Port parity: the KVStore and the Trainer's distributed paths.

* The local store's push and pull, the aggregation of a per-device list
  and the updater: the JAX package's cases (tests/test_trainer.py), the
  same values from both packages, exactly;
* a distributed store on a one-rank gloo group behaves as the JAX
  package's ``tpu`` store in one process; ``dist_async`` raises in both;
* over 2 gloo ranks (spawned as in tests/test_torch_data_parallel.py),
  ``Trainer(kvstore="dist_sync")`` on each rank's half of the batch, its
  loss summed over its rows, matches one process's Trainer on the whole
  batch, for a net without BatchNorm: through push and pull
  (``update_on_kvstore``), through ``allreduce_grads`` and ``update``, and
  with ``shard_optimizer`` (whose ``save_states`` gathers the shards; NAG,
  which has no pure step, updates unsharded), 3 steps each; weights and states within rtol 1e-5, atol 1e-6 (the same
  sums in another order).
"""
import os

import numpy as onp
import pytest

import mxnet_tpu_torch as mxt
from test_torch_data_parallel import WORLD, spawn_ranks

BATCH = 8
VARIANTS = {
    "push": dict(opt=("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                 update_on_kvstore=None, shard_optimizer=False),
    "allreduce": dict(opt=("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                      update_on_kvstore=False, shard_optimizer=False),
    "zero": dict(opt=("adam", {"learning_rate": 0.01}),
                 update_on_kvstore=None, shard_optimizer=True),
    # NAG has no pure step: the sharded update hands over to push and pull
    "zero_nag": dict(opt=("nag", {"learning_rate": 0.1, "momentum": 0.9}),
                     update_on_kvstore=None, shard_optimizer=True),
}


def _local_cases(pkg):
    nd = pkg.nd
    out = {}
    kv = pkg.kv.create("local")
    kv.init(3, nd.ones((2, 2)))
    kv.push(3, nd.ones((2, 2)) * 4.0)
    o = nd.zeros((2, 2))
    kv.pull(3, out=o)
    out["push_pull"] = o.asnumpy()
    kv = pkg.kv.create("local")
    kv.init("w", nd.zeros((3,)))
    kv.push("w", [nd.ones((3,)), nd.ones((3,)), nd.ones((3,))])
    o = nd.zeros((3,))
    kv.pull("w", out=o)
    out["aggregation"] = o.asnumpy()
    kv = pkg.kv.create("device")
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0, momentum=0.5))
    kv.init(0, nd.ones((2,)))
    for k in range(2):
        kv.push(0, [nd.ones((2,)), nd.ones((2,)) * 0.5])
    o = nd.zeros((2,))
    kv.pull(0, out=o)
    out["updater"] = o.asnumpy()
    return out


def test_local_store_matches_jax():
    import mxnet_tpu as mx
    want = _local_cases(mx)
    with mxt.cpu():
        got = _local_cases(mxt)
    assert set(got) == set(want)
    for k in want:
        onp.testing.assert_array_equal(got[k], want[k], err_msg=k)
    onp.testing.assert_array_equal(got["updater"], [-2.75, -2.75])


def test_dist_async_raises_and_compression_waits():
    import mxnet_tpu as mx
    for pkg in (mx, mxt):
        with pytest.raises(pkg.MXNetError):
            pkg.kv.create("dist_async")
    with pytest.raises(mxt.MXNetError, match="ROADMAP"):
        mxt.kv.create("local").set_gradient_compression({"type": "2bit"})


def test_dist_store_on_one_rank_is_the_jax_tpu_store():
    import torch.distributed as dist
    import mxnet_tpu as mx
    assert not dist.is_initialized()
    try:
        with mxt.cpu():
            kv = mxt.kv.create("dist_sync")
            assert dist.get_backend() == "gloo"
            assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "dist_sync")
            kv.init(0, mxt.nd.ones((2,)))
            kv.push(0, mxt.nd.ones((2,)) * 2.0)
            out = mxt.nd.zeros((2,))
            kv.pull(0, out=out)
            kv.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    jkv = mx.kv.create("tpu")
    jkv.init(0, mx.nd.ones((2,)))
    jkv.push(0, mx.nd.ones((2,)) * 2.0)
    jout = mx.nd.zeros((2,))
    jkv.pull(0, out=jout)
    onp.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())


def _net():
    nn = mxt.gluon.nn
    net = nn.HybridSequential(prefix="kvmlp_")
    with net.name_scope():
        net.add(nn.Dense(9, activation="relu", in_units=6),
                nn.Dense(3, in_units=9))
    return net


def _data():
    rs = onp.random.RandomState(4)
    x = rs.randn(3, BATCH, 6).astype("float32")
    return x, rs.randint(0, 3, (3, BATCH)).astype("float32")


def _train(variant, init, rows=slice(None), kvstore="device"):
    """3 Trainer steps of the net from ``init`` on ``rows`` of each batch;
    the weights and the optimizer states, by structural name."""
    spec = VARIANTS[variant]
    net = _net()
    net.initialize()
    mxt.gluon.utils.load_jax_params(net, init)
    name, kw = spec["opt"]
    trainer = mxt.gluon.Trainer(
        net.collect_params(), name, dict(kw), kvstore=kvstore,
        update_on_kvstore=spec["update_on_kvstore"],
        shard_optimizer=spec["shard_optimizer"])
    ce = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _data()
    for xx, yy in zip(x, y):
        with mxt.autograd.record():
            loss = ce(net(mxt.nd.array(xx[rows])), mxt.nd.array(yy[rows]))
        loss.backward()
        if variant == "allreduce" and kvstore != "device":
            trainer.allreduce_grads()
            trainer.update(BATCH)
        else:
            trainer.step(BATCH)
    states = {}
    if spec["shard_optimizer"] and kvstore != "device":
        trainer.save_states(os.devnull)     # gathers the shards first
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    for i, p in enumerate(trainer._params):
        st = trainer._updater.states.get(i)
        for j, s in enumerate(st if isinstance(st, tuple) else (st,)):
            if s is not None:
                states["%s/%d" % (names[id(p)], j)] = s.asnumpy()
    weights = {k: p.data().asnumpy()
               for k, p in net._collect_params_with_prefix().items()}
    return weights, states


def _kv_worker(mxt_, rank, out_dir):
    mesh = mxt_.parallel.device_mesh()
    mxt_.parallel.set_mesh(mesh)
    init = dict(onp.load(os.path.join(out_dir, "init.npz")))
    k = BATCH // WORLD
    with mxt_.cpu():
        for variant in VARIANTS:
            w, s = _train(variant, init, slice(rank * k, (rank + 1) * k),
                          kvstore="dist_sync")
            onp.savez(os.path.join(out_dir, "%s_%d.npz" % (variant, rank)),
                      **{"w/" + n: v for n, v in w.items()},
                      **{"s/" + n: v for n, v in s.items()})


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kv_ranks"))
    mxt.random.seed(9)
    with mxt.cpu():
        net = _net()
        net.initialize(mxt.init.Xavier())
        init = {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}
    onp.savez(os.path.join(out, "init.npz"), **init)
    spawn_ranks(_kv_worker, out)
    return init, {v: [dict(onp.load(os.path.join(out, "%s_%d.npz" % (v, r))))
                      for r in range(WORLD)] for v in VARIANTS}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dist_sync_trainer_matches_one_process(dist_runs, variant):
    init, runs = dist_runs
    with mxt.cpu():
        want_w, want_s = _train(variant, init)
    r0, r1 = runs[variant]
    for k, v in r0.items():
        onp.testing.assert_array_equal(r1[k], v, err_msg=k)
    assert {k[2:] for k in r0 if k.startswith("w/")} == set(want_w)
    assert {k[2:] for k in r0 if k.startswith("s/")} == set(want_s)
    assert want_s
    for k, v in want_w.items():
        onp.testing.assert_allclose(r0["w/" + k], v, rtol=1e-5, atol=1e-6,
                                    err_msg=k)
        assert not onp.array_equal(v, init[k]), k
    for k, v in want_s.items():
        onp.testing.assert_allclose(r0["s/" + k], v, rtol=1e-5, atol=1e-6,
                                    err_msg=k)
