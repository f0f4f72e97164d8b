"""Port parity: ``mxnet_tpu_torch.metric`` and the callbacks of
``mxnet_tpu_torch.callback`` that the rest-of-training slice added,
against the JAX package's, on the CPU.

Every metric of the JAX package (MAE, MSE, RMSE, F1 and MCC micro and
macro, Perplexity, PearsonCorrelation, NegativeLogLikelihood,
CustomMetric and ``np``, Torch, Caffe, and the ones ported before) is fed
the same three batches of NDArrays in both packages, with ``reset_local``
between the second and the third: ``get`` and ``get_global`` agree within
rtol 1e-12 (the math is numpy's on both sides, on the same float32
values), names included.  ``register``, ``alias`` and ``create`` accept
the JAX package's call forms and the port's older
``register(klass, *aliases)``; the callbacks log the JAX package's lines.
The small names of the slice: ``gluon.utils.check_sha1`` and
``shape_is_known``, ``nd.contrib.isfinite``/``isnan``/``isinf`` and its
forwarding to the registry, and ``mx.opt``, ``mx.num_gpus``,
``mx.cpu_pinned`` and ``mx.NDArray``.
"""
import hashlib
import logging

import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.callback import BatchEndParam

RS = onp.random.RandomState(0)
B, C = 16, 4
PROBS = [(lambda p: (p / p.sum(1, keepdims=True)).astype("float32"))(
    RS.uniform(0.05, 1, (B, C))) for _ in range(3)]
CLASSES = [RS.randint(0, C, B).astype("float32") for _ in range(3)]
BIN_PRED = [(lambda p: onp.stack([1 - p, p], 1).astype("float32"))(
    RS.uniform(0, 1, B)) for _ in range(3)]
BIN_LABEL = [RS.randint(0, 2, B).astype("float32") for _ in range(3)]
REG_PRED = [RS.randn(B, 3).astype("float32") for _ in range(3)]
REG_LABEL = [RS.randn(B, 3).astype("float32") for _ in range(3)]
SEQ_PROBS = [(lambda p: (p / p.sum(-1, keepdims=True)).astype("float32"))(
    RS.uniform(0.05, 1, (2, 5, C))) for _ in range(3)]
SEQ_LABEL = [RS.randint(0, C, (2, 5)).astype("float32") for _ in range(3)]


def _feval(label, pred):
    return float(onp.abs(label - pred.argmax(1)).sum()), label.size


CASES = {
    "mae": (lambda pkg: pkg.metric.MAE(), REG_LABEL, REG_PRED),
    "mse": (lambda pkg: pkg.metric.MSE(), REG_LABEL, REG_PRED),
    "rmse": (lambda pkg: pkg.metric.RMSE(), REG_LABEL, REG_PRED),
    "f1_macro": (lambda pkg: pkg.metric.F1(), BIN_LABEL, BIN_PRED),
    "f1_micro": (lambda pkg: pkg.metric.F1(average="micro"), BIN_LABEL,
                 BIN_PRED),
    "mcc_macro": (lambda pkg: pkg.metric.MCC(), BIN_LABEL, BIN_PRED),
    "mcc_micro": (lambda pkg: pkg.metric.MCC(average="micro"), BIN_LABEL,
                  BIN_PRED),
    "perplexity": (lambda pkg: pkg.metric.Perplexity(ignore_label=0),
                   SEQ_LABEL, SEQ_PROBS),
    "perplexity_all": (lambda pkg: pkg.metric.Perplexity(None), SEQ_LABEL,
                       SEQ_PROBS),
    "pearsonr": (lambda pkg: pkg.metric.PearsonCorrelation(), REG_LABEL,
                 REG_PRED),
    "nll": (lambda pkg: pkg.metric.NegativeLogLikelihood(), CLASSES, PROBS),
    "torch": (lambda pkg: pkg.metric.Torch(), CLASSES, PROBS),
    "caffe": (lambda pkg: pkg.metric.Caffe(), CLASSES, PROBS),
    "custom": (lambda pkg: pkg.metric.CustomMetric(_feval, name="dist"),
               CLASSES, PROBS),
    "np": (lambda pkg: pkg.metric.np(_feval), CLASSES, PROBS),
    "accuracy": (lambda pkg: pkg.metric.Accuracy(), CLASSES, PROBS),
    "top_k": (lambda pkg: pkg.metric.TopKAccuracy(top_k=2), CLASSES, PROBS),
    "ce": (lambda pkg: pkg.metric.CrossEntropy(), CLASSES, PROBS),
    "composite": (lambda pkg: pkg.metric.create(["acc", "ce", "nll_loss"]),
                  CLASSES, PROBS),
}


def _readings(pkg, make, labels, preds):
    kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    metric = make(pkg)
    out = []
    for k, (lab, prd) in enumerate(zip(labels, preds)):
        if k == 2:
            metric.reset_local()
        metric.update([pkg.nd.array(lab, **kw)], [pkg.nd.array(prd, **kw)])
        out.append((metric.get(), metric.get_global()))
    return out, metric


def _same(a, b):
    name_a, val_a = a
    name_b, val_b = b
    assert name_a == name_b
    onp.testing.assert_allclose(onp.asarray(val_a, dtype="float64"),
                                onp.asarray(val_b, dtype="float64"),
                                rtol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case):
    make, labels, preds = CASES[case]
    want, jm = _readings(mx, make, labels, preds)
    got, tm = _readings(mxt, make, labels, preds)
    for (g, gg), (w, wg) in zip(got, want):
        _same(g, w)
        _same(gg, wg)
    assert tm.get_name_value() == jm.get_name_value()
    if case not in ("custom", "np"):
        assert tm.get_config() == jm.get_config()


def test_register_alias_and_create_accept_both_call_forms():
    metric = mxt.metric

    class Twice(metric.MAE):
        def _score(self, err):
            return 2 * super()._score(err)
    assert metric.register(Twice) is Twice
    assert isinstance(metric.create("twice"), Twice)

    @metric.alias("thrice_a", "Thrice_B")
    class Thrice(metric.MAE):
        pass
    for name in ("thrice", "thrice_a", "thrice_b"):
        assert isinstance(metric.create(name), Thrice)
    # the port's older form: aliases after the class
    assert metric.register(Twice, "double") is Twice
    assert isinstance(metric.create("double"), Twice)
    # as the JAX package: a callable is a CustomMetric, names take
    # arguments, a list is a composite
    custom = metric.create(_feval)
    assert isinstance(custom, metric.CustomMetric) and custom.name == \
        mx.metric.create(_feval).name
    assert metric.create("top_k_acc", top_k=3).top_k == 3
    assert metric.create("acc").name == "accuracy"
    assert [m.name for m in metric.create(["ce", "pearsonr"]).metrics] == \
        ["cross-entropy", "pearsonr"]
    with pytest.raises(ValueError, match="registry"):
        metric.create("no-such-metric")
    with pytest.raises(TypeError):
        metric.create(3)
    args = {"perplexity": {"ignore_label": None},
            "custommetric": {"feval": _feval}}
    for name in ("nll_loss", "pearsonr", "mae", "mse", "rmse", "f1", "mcc",
                 "perplexity", "torch", "caffe", "custommetric"):
        got = metric.create(name, **args.get(name, {}))
        want = mx.metric.create(name, **args.get(name, {}))
        assert type(got).__name__ == type(want).__name__, name


def _logged(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        fn()
    return [r.getMessage() for r in caplog.records]


def test_callbacks_log_the_jax_packages_lines(caplog):
    lines = {}
    for pkg in (mx, mxt):
        kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
        metric = pkg.metric.Accuracy()
        metric.update([pkg.nd.array(CLASSES[0], **kw)],
                      [pkg.nd.array(PROBS[0], **kw)])
        param = BatchEndParam(epoch=1, nbatch=4, eval_metric=metric,
                              locals=None)
        bar = pkg.callback.ProgressBar(total=10, length=20)
        train = pkg.callback.log_train_metric(2, auto_reset=True)
        valid = pkg.callback.LogValidationMetricsCallback()
        lines[pkg] = (_logged(caplog, lambda: bar(param)),
                      _logged(caplog, lambda: valid(param)),
                      _logged(caplog, lambda: train(param)),
                      metric.get()[1])
    assert lines[mxt][:3] == lines[mx][:3]
    assert onp.isnan(lines[mxt][3]) and onp.isnan(lines[mx][3])
    assert lines[mxt][0] == ["[========------------] 40%\r"]


def test_small_names_match_jax(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(256)) * 5000)
    real = hashlib.sha1(path.read_bytes()).hexdigest()
    for pkg in (mx, mxt):
        assert pkg.gluon.utils.check_sha1(str(path), real)
        assert not pkg.gluon.utils.check_sha1(str(path), "0" * 40)
        for shape in (None, (2, 0), (2, -1), (3, 4), ()):
            assert mxt.gluon.utils.shape_is_known(shape) == \
                mx.gluon.utils.shape_is_known(shape)
    v = onp.array([1.0, onp.inf, -onp.inf, onp.nan, 0.0], "float32")
    for name in ("isfinite", "isnan", "isinf"):
        got = getattr(mxt.nd.contrib, name)(mxt.nd.array(v, ctx=mxt.cpu()))
        want = getattr(mx.nd.contrib, name)(mx.nd.array(v))
        assert got.dtype == mxt.nd.array(v, ctx=mxt.cpu()).dtype
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    # the registry's names, reached through the contrib namespace
    ok = mxt.nd.contrib.all_finite(mxt.nd.array(v[:1], ctx=mxt.cpu()))
    assert ok.asnumpy().item() == 1
    with pytest.raises(AttributeError):
        mxt.nd.contrib.no_such_op
    assert mxt.opt is mxt.optimizer
    assert mxt.NDArray is mxt.nd.NDArray
    assert mxt.num_gpus() == 0 and mxt.cpu_pinned() == \
        mxt.context.cpu_pinned()
    for name in ("opt", "num_gpus", "cpu_pinned", "NDArray"):
        assert hasattr(mx, name) and hasattr(mxt, name)
