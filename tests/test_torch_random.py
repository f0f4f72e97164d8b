"""Port parity for the samplers: ``mxnet_tpu_torch/ops/random_ops.py``,
``nd.random`` and ``mx.random``'s draws against the JAX package's
``mxnet_tpu/ops/random_ops.py``, ``ndarray/random.py`` and ``random.py``.

The two packages draw different numbers from the same seed, so parity is
in distribution, shape, dtype and device, never in value.  Each sampler's
shape and dtype equal the JAX package's for the same call; its mean and
variance over 10**5 draws (10**4 for a per-parameter sampler's row) lie
within 5 standard errors of the distribution's: the mean's standard error
is sqrt(var / n), the variance's sqrt((mu4 - var**2) / n), with mu4 the
distribution's fourth central moment (formulas in ``MOMENTS``).  Reseeding
reproduces the bits, ``generator_scope`` governs every draw, and a
hybridized block draws new numbers each call.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

N = 100_000
N_ROW = 10_000
SE = 5.0


def _nb(k, p):
    """Mean, variance and fourth central moment of the failures before
    the k-th success at rate p (excess kurtosis 6/k + p²/(k(1-p)))."""
    var = k * (1 - p) / p ** 2
    return k * (1 - p) / p, var, (3 + 6 / k + p * p / (k * (1 - p))) * var ** 2


def _discrete_uniform(lo, hi):
    n = hi - lo
    return (lo + hi - 1) / 2, (n * n - 1) / 12, (n * n - 1) * (3 * n * n - 7) / 240


# (op, attrs, (mean, var, mu4))
MOMENTS = [
    ("random_uniform", {"low": -1.0, "high": 3.0},
     (1.0, 16 / 12, 4 ** 4 / 80)),
    ("uniform", {}, (0.5, 1 / 12, 1 / 80)),
    ("_random_uniform", {"low": 2.0, "high": 2.5},
     (2.25, 0.25 / 12, 0.5 ** 4 / 80)),
    ("random_normal", {"loc": 1.5, "scale": 2.0}, (1.5, 4.0, 3 * 16.0)),
    ("normal", {}, (0.0, 1.0, 3.0)),
    ("_random_normal", {"loc": -3.0, "scale": 0.5},
     (-3.0, 0.25, 3 * 0.0625)),
    ("random_gamma", {"alpha": 2.5, "beta": 1.5},
     (3.75, 2.5 * 2.25, 3 * 2.5 * 4.5 * 1.5 ** 4)),
    ("_random_gamma", {"alpha": 0.5, "beta": 2.0},
     (1.0, 2.0, 3 * 0.5 * 2.5 * 16)),
    ("random_exponential", {"lam": 2.0}, (0.5, 0.25, 9 / 16)),
    ("_random_exponential", {"lam": 0.5}, (2.0, 4.0, 9 * 16)),
    ("random_poisson", {"lam": 4.0}, (4.0, 4.0, 4.0 * 13)),
    ("_random_poisson", {"lam": 0.7}, (0.7, 0.7, 0.7 * 3.1)),
    ("random_negative_binomial", {"k": 3, "p": 0.4}, _nb(3, 0.4)),
    ("_random_negative_binomial", {"k": 1, "p": 0.7}, _nb(1, 0.7)),
    ("random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     _nb(2.0, 2.0 / 4.0)),
    ("_random_generalized_negative_binomial", {"mu": 5.0, "alpha": 0.2},
     _nb(5.0, 5.0 / 10.0)),
    ("random_randint", {"low": -3, "high": 7}, _discrete_uniform(-3, 7)),
    ("randint", {"low": 0, "high": 3}, _discrete_uniform(0, 3)),
    ("_random_randint", {"low": 5, "high": 105}, _discrete_uniform(5, 105)),
]


def _check_moments(v, mean, var, mu4, what):
    v = onp.asarray(v, "float64").reshape(-1)
    n = v.size
    m, s2 = v.mean(), v.var()
    assert abs(m - mean) <= SE * math.sqrt(var / n), (what, m, mean)
    assert abs(s2 - var) <= SE * math.sqrt((mu4 - var * var) / n), \
        (what, s2, var)


def _dt(o):
    return str(o.dtype).replace("torch.", "")


@pytest.fixture(autouse=True)
def _seeded():
    mxt.random.seed(1234)
    yield


@pytest.mark.parametrize("op, attrs, moments", MOMENTS,
                         ids=["%s-%s" % (m[0], "-".join(
                             "%s=%s" % kv for kv in sorted(m[1].items())))
                              for m in MOMENTS])
def test_sampler_shape_dtype_device_and_moments(op, attrs, moments):
    j = getattr(mx.nd, op)(shape=(2, 3), **attrs)
    p = getattr(mxt.nd, op)(shape=(2, 3), ctx=mxt.cpu(), **attrs)
    assert (p.shape, _dt(p)) == (j.shape, _dt(j))
    assert p.context == mxt.cpu()
    big = getattr(mxt.nd, op)(shape=(N,), ctx=mxt.cpu(), **attrs)
    _check_moments(big.asnumpy(), *moments, what=op)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_sampler_dtypes(dtype):
    for op in ("random_uniform", "random_normal", "random_gamma",
               "random_exponential", "random_poisson"):
        p = getattr(mxt.nd, op)(shape=(4,), dtype=dtype, ctx=mxt.cpu())
        assert _dt(p) == dtype, op
    j = mx.nd.random_uniform(shape=(4,), dtype="float16")
    assert _dt(j) == "float16"
    assert _dt(mxt.nd.random_randint(0, 5, shape=(3,), dtype="int32",
                                     ctx=mxt.cpu())) == "int32"


def _params(*pairs):
    return [onp.array(p, "float32") for p in pairs]


# (op, parameter arrays, mean and variance a row, fourth moment a row)
SAMPLE_CASES = [
    ("sample_uniform", _params([0.0, -2.0], [1.0, 2.0]),
     lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12, (b - a) ** 4 / 80)),
    ("_sample_uniform", _params([[1.0], [5.0]], [[3.0], [5.5]]),
     lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12, (b - a) ** 4 / 80)),
    ("sample_normal", _params([0.0, 10.0], [1.0, 3.0]),
     lambda m, s: (m, s * s, 3 * s ** 4)),
    ("_sample_normal", _params([-1.0, 2.0], [0.5, 0.1]),
     lambda m, s: (m, s * s, 3 * s ** 4)),
    ("sample_gamma", _params([1.0, 4.0], [2.0, 0.5]),
     lambda a, b: (a * b, a * b * b, 3 * a * (a + 2) * b ** 4)),
    ("_sample_gamma", _params([0.3, 9.0], [1.0, 1.0]),
     lambda a, b: (a * b, a * b * b, 3 * a * (a + 2) * b ** 4)),
]


@pytest.mark.parametrize("op, params, moments", SAMPLE_CASES,
                         ids=[c[0] for c in SAMPLE_CASES])
def test_per_parameter_sampler(op, params, moments):
    j = getattr(mx.nd, op)(*[mx.nd.array(p) for p in params], shape=(5,))
    p = getattr(mxt.nd, op)(*[mxt.nd.array(q, ctx=mxt.cpu()) for q in params],
                            shape=(5,))
    assert (p.shape, _dt(p)) == (j.shape, _dt(j))
    big = getattr(mxt.nd, op)(*[mxt.nd.array(q, ctx=mxt.cpu())
                                for q in params], shape=(N_ROW,)).asnumpy()
    flat = [q.reshape(-1) for q in params]
    rows = big.reshape(flat[0].size, N_ROW)
    for r in range(rows.shape[0]):
        _check_moments(rows[r], *moments(*[float(f[r]) for f in flat]),
                       what="%s row %d" % (op, r))


@pytest.mark.parametrize("op", ["multinomial", "sample_multinomial",
                                "_sample_multinomial"])
def test_multinomial_frequencies(op):
    probs = onp.array([[0.1, 0.6, 0.0, 0.3], [0.25, 0.25, 0.25, 0.25]],
                      "float32")
    j = getattr(mx.nd, op)(mx.nd.array(probs), shape=(3,))
    p = getattr(mxt.nd, op)(mxt.nd.array(probs, ctx=mxt.cpu()), shape=(3,))
    assert (p.shape, _dt(p)) == (j.shape, _dt(j)) == ((2, 3), "int32")
    one = getattr(mxt.nd, op)(mxt.nd.array(probs[0], ctx=mxt.cpu()))
    assert one.shape == () and _dt(one) == "int32"
    draws = getattr(mxt.nd, op)(mxt.nd.array(probs, ctx=mxt.cpu()),
                                shape=(N,)).asnumpy()
    for r in range(2):
        freq = onp.bincount(draws[r], minlength=4) / N
        se = onp.sqrt(probs[r] * (1 - probs[r]) / N)
        assert (abs(freq - probs[r]) <= SE * se + 1e-12).all(), (r, freq)


def test_multinomial_get_prob_returns_the_log_probabilities():
    probs = onp.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], "float32")
    draws, logp = mxt.nd.random.multinomial(
        mxt.nd.array(probs, ctx=mxt.cpu()), shape=(7,), get_prob=True)
    d = draws.asnumpy()
    assert d.shape == logp.shape == (2, 7) and _dt(logp) == "float32"
    want = onp.log(onp.take_along_axis(probs, d.astype("int64"), axis=1))
    onp.testing.assert_allclose(logp.asnumpy(), want, rtol=1e-6)


@pytest.mark.parametrize("op", ["shuffle", "_shuffle"])
def test_shuffle_permutes_rows(op):
    x = onp.arange(40, dtype="float32").reshape(20, 2)
    j = getattr(mx.nd, op)(mx.nd.array(x))
    p = getattr(mxt.nd, op)(mxt.nd.array(x, ctx=mxt.cpu()))
    assert (p.shape, _dt(p)) == (j.shape, _dt(j))
    got = p.asnumpy()
    assert not onp.array_equal(got, x)
    assert onp.array_equal(got[onp.argsort(got[:, 0])], x)
    # each row lands in each position about equally often
    first = [getattr(mxt.nd, op)(mxt.nd.arange(4, ctx=mxt.cpu()))
             .asnumpy()[0] for _ in range(2000)]
    freq = onp.bincount(onp.array(first, "int64"), minlength=4) / 2000
    assert (abs(freq - 0.25) <= SE * math.sqrt(0.25 * 0.75 / 2000)).all()


def test_every_sampler_is_ported_and_has_a_case():
    names = [n for n in jreg.list_ops()
             if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.random_ops"]
    assert len(names) == 30
    assert [n for n in names if treg.get_op(n) is None] == []
    assert all(treg.get_op(n).needs_rng for n in names)
    covered = {m[0] for m in MOMENTS} | {c[0] for c in SAMPLE_CASES} | {
        "multinomial", "sample_multinomial", "_sample_multinomial",
        "shuffle", "_shuffle"}
    assert [n for n in names if n not in covered] == []


def test_nd_random_and_mx_random_forward_to_the_ops():
    for name in ("uniform", "normal", "gamma", "exponential", "poisson",
                 "negative_binomial", "generalized_negative_binomial",
                 "randint"):
        kw = {"low": 0, "high": 5} if name == "randint" else {}
        p = getattr(mxt.nd.random, name)(shape=(3,), ctx=mxt.cpu(), **kw)
        q = getattr(mxt.random, name)(shape=(3,), ctx=mxt.cpu(), **kw)
        j = getattr(mx.nd.random, name)(shape=(3,), **kw)
        assert (p.shape, _dt(p)) == (q.shape, _dt(q)) == (j.shape, _dt(j))
    r = mxt.nd.random.randn(2, 3, ctx=mxt.cpu())
    assert r.shape == mx.nd.random.randn(2, 3).shape == (2, 3)
    with pytest.raises(AttributeError):
        mxt.nd.random.no_such_draw


def test_reseeding_reproduces_and_seeds_differ():
    def draw():
        return [mxt.nd.random.normal(shape=(5,), ctx=mxt.cpu()).asnumpy(),
                mxt.nd.random.poisson(3.0, shape=(5,), ctx=mxt.cpu())
                .asnumpy(),
                mxt.nd.shuffle(mxt.nd.arange(6, ctx=mxt.cpu())).asnumpy()]
    mxt.random.seed(7)
    a = draw()
    mxt.random.seed(7)
    b = draw()
    mxt.random.seed(8)
    c = draw()
    for x, y in zip(a, b):
        assert onp.array_equal(x, y)
    assert not onp.array_equal(a[0], c[0])


def test_generator_scope_governs_every_draw():
    """Inside ``generator_scope(g)`` the samplers draw from ``g`` (the
    same bits as a generator seeded alike) and leave the device's own
    generator where it was."""
    def draws():
        return [mxt.nd.random.uniform(shape=(4,), ctx=mxt.cpu()).asnumpy(),
                mxt.nd.random.gamma(2.0, shape=(4,), ctx=mxt.cpu()).asnumpy(),
                mxt.nd.sample_normal(mxt.nd.zeros((2,), ctx=mxt.cpu()),
                                     mxt.nd.ones((2,), ctx=mxt.cpu()),
                                     shape=(3,)).asnumpy()]
    own = mxt.random.generator("cpu").get_state()
    with mxt.random.generator_scope(torch.Generator().manual_seed(99)):
        got = draws()
    assert torch.equal(mxt.random.generator("cpu").get_state(), own)
    with mxt.random.generator_scope(torch.Generator().manual_seed(99)):
        again = draws()
    for x, y in zip(got, again):
        assert onp.array_equal(x, y)
    assert not onp.array_equal(draws()[0], got[0])


def test_samplers_default_to_the_card(monkeypatch):
    """No ``ctx=``: the draw goes to the current context, the card, and
    raises without CUDA rather than drawing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.nd.random.normal(shape=(2,))
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.random.uniform(shape=(2,))
    with mxt.cpu():
        assert mxt.nd.random.normal(shape=(2,)).context == mxt.cpu()
    assert mxt.nd.random.normal(shape=(2,), ctx="cpu(0)").context == mxt.cpu()


class _Noisy(mxt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x + F.random.normal(shape=x.shape, ctx=x.context)


def test_hybridized_block_draws_anew_each_call():
    """A hybridized block that draws (``F.random.normal``) gives new
    numbers each call in predict mode too, as the JAX package's
    ``_CachedGraph`` takes a fresh key each call; reseeding repeats them."""
    with mxt.cpu():
        net = _Noisy()
        net.hybridize()
        x = mxt.nd.zeros((3, 4))
        mxt.random.seed(5)
        a, b = net(x).asnumpy(), net(x).asnumpy()
        mxt.random.seed(5)
        c = net(x).asnumpy()
    assert not onp.array_equal(a, b)
    assert onp.array_equal(a, c)
