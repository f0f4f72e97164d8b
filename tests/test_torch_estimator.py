"""Port parity: ``mxnet_tpu_torch.gluon.contrib.estimator`` against the
JAX package's, on the CPU: a small MLP (5-8-3) trained by ``fit`` for 2
epochs of 3 batches from a ``DataLoader``, the same numpy weights and
batches in both packages, with validation data and the handlers
(``CheckpointHandler``, ``EarlyStoppingHandler``, per-batch
``LoggingHandler``).

Weights within atol 1e-5 and metrics within rtol 1e-5 (as
tests/test_torch_train.py holds the Trainer's steps); the checkpoint
files have the JAX package's names, and the port's parameters and states
files load into the JAX package's net and Trainer.  ``fit(batches=)``,
early stopping at the JAX package's epoch, ``evaluate``, the default
trainer (Adam at 1e-3) and the default context (the current one: without
a CPU scope the port asks for the card and raises here) are held too.
"""
import os

import numpy as onp
import pytest

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.utils import load_jax_params

RS = onp.random.RandomState(0)
X = RS.randn(24, 5).astype("float32")
Y = RS.randint(0, 3, 24).astype("float32")
XV = RS.randn(8, 5).astype("float32")
YV = RS.randint(0, 3, 8).astype("float32")
W0 = {"0.weight": (RS.randn(8, 5) * 0.5).astype("float32"),
      "0.bias": (RS.randn(8) * 0.1).astype("float32"),
      "1.weight": (RS.randn(3, 8) * 0.5).astype("float32"),
      "1.bias": (RS.randn(3) * 0.1).astype("float32")}


def _net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="estmlp_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=5),
                nn.Dense(3, in_units=8))
    if pkg is mx:
        net.initialize()
        for k, p in net._collect_params_with_prefix().items():
            p._data._data = jax.numpy.asarray(W0[k])
    else:
        net.initialize(ctx=mxt.cpu())
        load_jax_params(net, W0)
    return net


def _loader(pkg, x, y):
    return pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(x, y),
                                     batch_size=8)


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _fit(pkg, model_dir, trainer_name="nadam", **fit_kw):
    est_mod = pkg.gluon.contrib.estimator
    net = _net(pkg)
    acc = pkg.metric.Accuracy()
    loss_metric = pkg.metric.Loss()
    trainer = pkg.gluon.Trainer(net.collect_params(), trainer_name,
                                {"learning_rate": 0.05})
    kw = {"context": mxt.cpu()} if pkg is mxt else {}
    est = est_mod.Estimator(
        net, loss=pkg.gluon.loss.SoftmaxCrossEntropyLoss(prefix="estce_"),
        metrics=[acc, loss_metric], trainer=trainer, **kw)
    handlers = [
        est_mod.CheckpointHandler(model_dir, model_prefix="mlp",
                                  monitor=acc, save_best=True,
                                  max_checkpoints=2),
        est_mod.EarlyStoppingHandler(monitor=loss_metric, patience=3),
        est_mod.LoggingHandler(verbose=est_mod.LoggingHandler.LOG_PER_BATCH,
                               train_metrics=[acc, loss_metric])]
    est.fit(_loader(pkg, X, Y), val_data=_loader(pkg, XV, YV),
            event_handlers=handlers, **fit_kw)
    return est, handlers


def _run_both(tmp_path, **fit_kw):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jest, jh = _fit(mx, jdir, **fit_kw)
    with mxt.cpu():
        test, th = _fit(mxt, tdir, **fit_kw)
    return (jest, jh, jdir), (test, th, tdir)


def _close_metrics(got, want):
    for g, w in zip(got, want):
        assert g.get()[0] == w.get()[0]
        onp.testing.assert_allclose(g.get()[1], w.get()[1], rtol=1e-5)


def test_fit_two_epochs_with_handlers_matches_jax(tmp_path):
    (jest, jh, jdir), (test, th, tdir) = _run_both(tmp_path, epochs=2)
    jw, tw = _weights(jest.net), _weights(test.net)
    for k in jw:
        onp.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                    err_msg=k)
        assert not onp.array_equal(tw[k], W0[k])
    _close_metrics(test.train_metrics, jest.train_metrics)
    _close_metrics(test.val_metrics, jest.val_metrics)
    assert [m.name for m in test.val_metrics] == \
        ["validation accuracy", "validation loss"]
    # two epochs of three batches: the checkpoints of both epochs, the best
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "mlp-best.params", "mlp-epoch1batch3.params",
        "mlp-epoch1batch3.states", "mlp-epoch2batch6.params",
        "mlp-epoch2batch6.states"]
    assert th[0].saved_checkpoints == [
        os.path.join(tdir, "mlp-epoch1batch3.params"),
        os.path.join(tdir, "mlp-epoch2batch6.params")]
    # the port's files in the JAX package
    jnet = _net(mx)
    jnet.load_parameters(os.path.join(tdir, "mlp-epoch2batch6.params"))
    for k, v in _weights(jnet).items():
        onp.testing.assert_array_equal(v, tw[k])
    jtr = mx.gluon.Trainer(jnet.collect_params(), "nadam",
                           {"learning_rate": 0.05})
    jtr.load_states(os.path.join(tdir, "mlp-epoch2batch6.states"))
    assert jtr.optimizer.num_update == test.trainer.optimizer.num_update == 6
    assert jtr.optimizer.m_schedule == test.trainer.optimizer.m_schedule
    # the JAX package's checkpoint in the port
    with mxt.cpu():
        tnet = _net(mxt)
        tnet.load_parameters(os.path.join(jdir, "mlp-epoch2batch6.params"),
                             ctx=mxt.cpu())
    for k, v in _weights(tnet).items():
        onp.testing.assert_array_equal(v, jw[k])


def test_fit_by_batches_and_evaluate_match_jax(tmp_path):
    (jest, _, _), (test, th, _) = _run_both(tmp_path, batches=4)
    jw, tw = _weights(jest.net), _weights(test.net)
    for k in jw:
        onp.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5)
    assert th[1].current_epoch == 1        # one whole epoch, then 1 batch
    want = jest.evaluate(_loader(mx, XV, YV), [mx.metric.Accuracy(),
                                               mx.metric.Loss()])
    with mxt.cpu():
        got = test.evaluate(_loader(mxt, XV, YV), [mxt.metric.Accuracy(),
                                                   mxt.metric.Loss()])
    _close_metrics(got, want)


def test_early_stopping_stops_where_jax_stops(tmp_path):
    def run(pkg):
        est_mod = pkg.gluon.contrib.estimator
        net = _net(pkg)
        acc = pkg.metric.Accuracy()
        kw = {"context": mxt.cpu()} if pkg is mxt else {}
        est = est_mod.Estimator(net, metrics=acc, trainer=pkg.gluon.Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.0}), **kw)
        stop = est_mod.EarlyStoppingHandler(monitor=acc, patience=1,
                                            mode="max")
        est.fit(_loader(pkg, X, Y), epochs=6, event_handlers=[stop])
        return stop.stopped_epoch, stop.current_epoch
    want = run(mx)
    with mxt.cpu():
        got = run(mxt)
    assert got == want == (1, 2)


def test_default_trainer_metric_and_loss_are_the_jax_packages():
    with mxt.cpu():
        est = mxt.gluon.contrib.estimator.Estimator(_net(mxt))
        assert est.context == [mxt.cpu()]
    jest = mx.gluon.contrib.estimator.Estimator(_net(mx))
    for e in (est, jest):
        assert type(e.trainer.optimizer).__name__ == "Adam"
        assert e.trainer.learning_rate == 1e-3
        assert type(e.loss).__name__ == "SoftmaxCrossEntropyLoss"
        assert [type(m).__name__ for m in e.train_metrics] == ["Accuracy"]
    with pytest.raises(ValueError, match="exactly one"):
        est.fit([], epochs=1, batches=1)


def test_default_context_is_the_card_and_never_the_cpu():
    net = mxt.gluon.nn.Dense(3, in_units=5, prefix="estgpu_")
    est_mod = mxt.gluon.contrib.estimator
    assert est_mod.Estimator._check_context(None) == [mxt.gpu(0)]
    with pytest.raises(Exception, match="CUDA|cuda"):
        est_mod.Estimator(net)
