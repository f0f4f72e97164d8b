"""Port parity: the data and bookkeeping side of training in
``mxnet_tpu_torch`` against the JAX package, on the same numpy inputs:
``io.NDArrayIter`` (pad/discard/roll_over), ``gluon.data`` (ArrayDataset,
samplers, DataLoader), the lr schedulers, ``metric`` (Accuracy,
TopKAccuracy, CrossEntropy, Loss, composite), ``gluon.utils``
(split_and_load, clip_global_norm) and ``callback.Speedometer``.

Batches, learning rates and metric values are equal to the JAX package's
(float32 batches bit for bit; floats within rel 1e-6: the metrics sum in
numpy on both sides, and clip_global_norm's norm is a float32 sum in
another order).  Shuffling draws from the port's own ``torch.Generator``,
so a shuffled order is checked for being a permutation that the seed
fixes, not against the JAX package's numpy order.
"""
import logging

import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.callback import BatchEndParam, Speedometer

X = onp.arange(10 * 3, dtype="float32").reshape(10, 3)
Y = onp.arange(10, dtype="float32")


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
        it.reset()
    return out


@pytest.mark.parametrize("policy", ["pad", "discard", "roll_over"])
def test_ndarrayiter_last_batch_policies_match_jax(policy):
    want = _batches(mx.io.NDArrayIter(X, Y, batch_size=4,
                                      last_batch_handle=policy))
    with mxt.cpu():
        it = mxt.io.NDArrayIter(X, Y, batch_size=4, last_batch_handle=policy)
        assert it.provide_data[0].shape == (4, 3)
        got = _batches(it)
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        onp.testing.assert_array_equal(gd[0], wd[0])
        onp.testing.assert_array_equal(gl[0], wl[0])


def test_ndarrayiter_shuffle_is_a_seeded_permutation():
    def epoch(seed):
        mxt.random.seed(seed)
        with mxt.cpu():
            it = mxt.io.NDArrayIter(X, Y, batch_size=5, shuffle=True)
            return onp.concatenate([b.label[0].asnumpy() for b in it])
    first = epoch(7)
    assert sorted(first.tolist()) == Y.tolist()
    onp.testing.assert_array_equal(epoch(7), first)
    assert not onp.array_equal(first, Y)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_jax(last_batch):
    def run(pkg, **kw):
        ds = pkg.gluon.data.ArrayDataset(X, Y)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=4,
                                           last_batch=last_batch)
        out = []
        for _ in range(2):
            out += [(d.asnumpy(), l.asnumpy()) for d, l in loader]
        return out, len(loader)
    want, n_want = run(mx)
    with mxt.cpu():
        got, n_got = run(mxt)
    assert n_got == n_want and len(got) == len(want)
    for (gd, gl), (wd, wl) in zip(got, want):
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)


def test_dataloader_shuffle_and_refusals():
    mxt.random.seed(3)
    with mxt.cpu():
        ds = mxt.gluon.data.ArrayDataset(X, Y)
        labels = onp.concatenate([l.asnumpy() for _, l in
                                  mxt.gluon.data.DataLoader(
                                      ds, batch_size=3, shuffle=True)])
        assert sorted(labels.tolist()) == Y.tolist()
        with pytest.raises(ValueError, match="shuffle must not"):
            mxt.gluon.data.DataLoader(
                ds, batch_size=3, shuffle=True,
                sampler=mxt.gluon.data.SequentialSampler(len(ds)))
        first = ds.transform_first(lambda d: d * 2)[1]
        onp.testing.assert_array_equal(first[0], X[1] * 2)
        assert len(ds.shard(3, 0)) == 4 and len(ds.take(2)) == 2


SCHEDULERS = [
    ("FactorScheduler", dict(step=5, factor=0.5, base_lr=0.1)),
    ("MultiFactorScheduler", dict(step=[3, 9, 20], factor=0.3, base_lr=0.2,
                                  warmup_steps=2, warmup_begin_lr=0.01)),
    ("PolyScheduler", dict(max_update=30, base_lr=0.1, pwr=2, final_lr=0.01,
                           warmup_steps=4)),
    ("CosineScheduler", dict(max_update=25, base_lr=0.1, final_lr=0.001,
                             warmup_steps=3, warmup_mode="constant",
                             warmup_begin_lr=0.05)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=[s[0] for s in SCHEDULERS])
def test_lr_schedulers_match_jax(name, kw):
    want = getattr(mx.lr_scheduler, name)(**kw)
    got = getattr(mxt.lr_scheduler, name)(**kw)
    for n in range(40):
        assert got(n) == pytest.approx(want(n), rel=1e-12), n


def test_scheduler_drives_the_optimizer_lr():
    sched = mxt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = mxt.optimizer.SGD(learning_rate=0.4, lr_scheduler=sched)
    assert sched.base_lr == 0.4
    opt.num_update = 5
    assert opt.learning_rate == pytest.approx(0.1)
    with pytest.raises(UserWarning):
        opt.set_learning_rate(0.3)


def _metric_inputs():
    rng = onp.random.RandomState(5)
    logits = rng.randn(12, 6).astype("float32")
    probs = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    labels = rng.randint(0, 6, 12).astype("float32")
    return probs, labels


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.metric.Accuracy(),
    lambda pkg: pkg.metric.TopKAccuracy(top_k=3),
    lambda pkg: pkg.metric.CrossEntropy(),
    lambda pkg: pkg.metric.Loss(),
    lambda pkg: pkg.metric.create(["acc", "ce"]),
], ids=["acc", "top3", "ce", "loss", "composite"])
def test_metrics_match_jax(make):
    probs, labels = _metric_inputs()
    results = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        m = make(pkg)
        for lo, hi in ((0, 5), (5, 12)):
            m.update([pkg.nd.array(labels[lo:hi], **kw)],
                     [pkg.nd.array(probs[lo:hi], **kw)])
            if lo == 0:
                m.reset_local()
        results.append((m.get_name_value(), m.get_global_name_value()))
    (tw, tg), (jw, jg) = results[1], results[0]
    for got, want in ((tw, jw), (tg, jg)):
        assert [n for n, _ in got] == [n for n, _ in want]
        onp.testing.assert_allclose([v for _, v in got],
                                    [v for _, v in want], rtol=1e-6)


def test_split_and_load_and_clip_global_norm_match_jax():
    a = onp.random.RandomState(6).randn(6, 4).astype("float32")
    parts = mxt.gluon.utils.split_and_load(a, [mxt.cpu(), mxt.cpu()])
    want = mx.gluon.utils.split_and_load(a, [mx.cpu(), mx.cpu()])
    for p, w in zip(parts, want):
        onp.testing.assert_array_equal(p.asnumpy(), w.asnumpy())
    with pytest.raises(ValueError):
        mxt.gluon.utils.split_data(mxt.nd.array(a, ctx=mxt.cpu()), 4)
    for max_norm in (1.0, 100.0):
        t = [mxt.nd.array(a, ctx=mxt.cpu()),
             mxt.nd.array(a[:2] * 3, ctx=mxt.cpu())]
        j = [mx.nd.array(a), mx.nd.array(a[:2] * 3)]
        tn = mxt.gluon.utils.clip_global_norm(t, max_norm)
        jn = mx.gluon.utils.clip_global_norm(j, max_norm)
        assert tn == pytest.approx(jn, rel=1e-6)
        for x, y in zip(t, j):
            onp.testing.assert_allclose(x.asnumpy(), y.asnumpy(), rtol=1e-6)


def test_speedometer_logs_speed_and_metric(caplog):
    sp = Speedometer(batch_size=8, frequent=2)
    metric = mxt.metric.Loss()
    metric.update(None, [onp.array([1.0, 3.0])])
    with caplog.at_level(logging.INFO):
        for n in range(5):
            sp(BatchEndParam(epoch=0, nbatch=n, eval_metric=metric,
                             locals=None))
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2 and "samples/sec" in lines[0]
    assert "loss=2.000000" in lines[0] and sp.speed > 0


def test_array_dataset_of_an_ndarray_matches_jax():
    """An NDArray in an ArrayDataset: its length is its first axis, and a
    sample holds its row."""
    labels = onp.arange(4)
    jds = mx.gluon.data.ArrayDataset(mx.nd.zeros((4, 2)), labels)
    with mxt.cpu():
        tds = mxt.gluon.data.ArrayDataset(mxt.nd.zeros((4, 2)), labels)
        assert len(mxt.nd.zeros((3, 5))) == 3
    assert len(tds) == len(jds) == 4
    assert tds[1][0].shape == jds[1][0].shape == (2,)
    assert int(tds[1][1]) == int(jds[1][1]) == 1
