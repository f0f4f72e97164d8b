"""Port parity: ``mx.nd.contrib.foreach``, ``while_loop`` and ``cond``
(``mxnet_tpu_torch/ops/control_flow.py``) against the JAX package's, on
the CPU, from the same numpy inputs: results outside ``autograd.record()``
and inside it, and the gradients of the loop's inputs and of the arrays
its callables close over.  Tolerance: rtol 1e-6, atol 1e-7 (the same
float32 ops in the same order).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

TOL = dict(rtol=1e-6, atol=1e-7)
X = onp.random.RandomState(0).uniform(-1, 1, (4, 3)).astype("float32")
W = onp.random.RandomState(1).uniform(0.5, 1.5, (3,)).astype("float32")


def _close(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def _foreach(pkg, record):
    nd = pkg.nd
    data = nd.array(X)
    w = nd.array(W)
    w.attach_grad()
    data.attach_grad()

    def body(x, states):
        s, acc = states
        new = s * 0.5 + x * w
        return [new, new * new], [new, acc + new.sum()]

    def run():
        outs, finals = nd.contrib.foreach(body, data,
                                          [nd.zeros((3,)), nd.zeros((1,))])
        return outs, finals, (outs[1].sum() + finals[1].sum())

    if not record:
        return run()[:2]
    with pkg.autograd.record():
        outs, finals, loss = run()
    loss.backward()
    return outs, finals, data.grad, w.grad


def _while(pkg, record, limit):
    nd = pkg.nd
    x = nd.array([1.5])
    x.attach_grad()

    def cond(i, acc):
        return i < limit

    def func(i, acc):
        return [acc * 2, i], [i + 1, acc * x]

    def run():
        return nd.contrib.while_loop(cond, func,
                                     [nd.array([0.0]), nd.ones((1,))],
                                     max_iterations=6)

    if not record:
        return run()
    with pkg.autograd.record():
        outs, (i, acc) = run()
        loss = (acc * x).sum()
    loss.backward()
    return outs, [i, acc], x.grad


def _cond(pkg, record, pred_value):
    nd = pkg.nd
    x = nd.array([3.0, -2.0])
    x.attach_grad()
    pred = nd.array([pred_value])

    def run():
        return nd.contrib.cond(pred, lambda: x * x, lambda: x * 3)

    if not record:
        return run()
    with pkg.autograd.record():
        out = run()
        out.sum().backward()
    return out, x.grad


@pytest.mark.parametrize("record", [False, True])
def test_foreach_matches_jax(record):
    with mxt.cpu():
        got = _foreach(mxt, record)
    _close(got, _foreach(mx, record))


@pytest.mark.parametrize("limit", [0, 3, 10])
@pytest.mark.parametrize("record", [False, True])
def test_while_loop_matches_jax(record, limit):
    """``limit`` 3 stops the loop early, 10 runs into max_iterations, 0
    runs no step (one zero row outside record, None inside it)."""
    with mxt.cpu():
        got = _while(mxt, record, limit)
    _close(got, _while(mx, record, limit))


@pytest.mark.parametrize("pred_value", [0.0, 1.0])
@pytest.mark.parametrize("record", [False, True])
def test_cond_matches_jax(record, pred_value):
    with mxt.cpu():
        got = _cond(mxt, record, pred_value)
    _close(got, _cond(mx, record, pred_value))


def test_cond_takes_python_predicates():
    with mxt.cpu():
        x = mxt.nd.array([2.0])
        assert mxt.nd.contrib.cond(True, lambda: x, lambda: x * 0) is x
        assert mxt.nd.contrib.cond(0, lambda: x * 0, lambda: x) is x


def test_while_loop_requires_max_iterations():
    with pytest.raises(ValueError):
        mxt.nd.contrib.while_loop(lambda i: i < 1, lambda i: (i, [i]),
                                  [mxt.nd.zeros((1,), ctx=mxt.cpu())])
