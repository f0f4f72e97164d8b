"""Port parity: the Gluon layers, contrib layers, initializers, parameter
files and block utilities of the vision slice, against the JAX package.

Layers are built in both packages under the same explicit prefix (so no
auto-naming counter moves), the JAX layer's weights carried into the
port's by ``load_jax_params``, and the same seeded input run through
both; forwards within 2e-5 of the largest JAX output in magnitude
(float32, other summation orders), gradients likewise.  Random
initializers draw from the port's generator and the JAX package's host
numpy generator, so they are held to their properties (an orthogonal
basis, a standard deviation within 5% on 40 000 draws) and ``Bilinear``
to the JAX package's values exactly.  Parameter files written by either
package are read by the other.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.gluon import contrib as jcontrib
from mxnet_tpu.gluon.utils import materialize_params
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon.utils import load_jax_params

RTOL = 2e-5


def _x(seed, shape, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype("float32")


def _close(got, want, what):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(onp.abs(got - want).max())
    scale = max(float(onp.abs(want).max()), 1e-6)
    assert err <= RTOL * scale, "%s: max err %.3g > %.3g" % (
        what, err, RTOL * scale)


def _pair(make, x, grad=False, init=None):
    """``make(pkg, prefix)`` built in both packages, the JAX block's
    weights carried over; returns (port output, JAX output) on ``x`` and,
    with ``grad``, the input gradients of ``sum(out * ct)`` too."""
    jb, tb = make(mx, "lay_"), make(mxt, "lay_")
    jb.initialize(init or mx.init.Xavier())
    materialize_params(jb, mx.nd.array(x))
    jb.hybridize()
    arrays = {k: p.data().asnumpy()
              for k, p in jb._collect_params_with_prefix().items()}
    with mxt.cpu():
        tb.initialize()
        if arrays:
            load_jax_params(tb, arrays)
        jx, tx = mx.nd.array(x), mxt.nd.array(x)
        if not grad:
            return tb(tx).asnumpy(), jb(jx).asnumpy()
        jx.attach_grad()
        tx.attach_grad()
        with mx.autograd.record():
            jo = jb(jx)
            ct = onp.random.RandomState(9).standard_normal(jo.shape) \
                .astype("float32")
            jl = (jo * mx.nd.array(ct)).sum()
        jl.backward()
        with mxt.autograd.record():
            to = tb(tx)
            tl = (to * mxt.nd.array(ct)).sum()
        tl.backward()
        return (to.asnumpy(), jo.asnumpy(), tx.grad.asnumpy(),
                jx.grad.asnumpy())


def _check(make, x, grad=False, init=None, what=""):
    out = _pair(make, x, grad=grad, init=init)
    _close(out[0], out[1], what + " forward")
    if grad:
        _close(out[2], out[3], what + " input gradient")


# -- convolution and pooling layers ----------------------------------------

CONV_LAYERS = [
    ("Conv1D", (2, 3, 9), dict(channels=4, kernel_size=3, strides=2,
                                padding=1, use_bias=True)),
    ("Conv3D", (1, 2, 5, 5, 5), dict(channels=3, kernel_size=(2, 3, 2),
                                      padding=(0, 1, 1), groups=1)),
    ("Conv1DTranspose", (2, 4, 6), dict(channels=3, kernel_size=3,
                                         strides=2, padding=1,
                                         output_padding=1)),
    ("Conv2DTranspose", (2, 4, 5, 5), dict(channels=6, kernel_size=3,
                                            strides=2, padding=1,
                                            output_padding=1, groups=2,
                                            activation="relu")),
    ("Conv3DTranspose", (1, 2, 3, 3, 3), dict(channels=2, kernel_size=2,
                                               strides=2)),
    ("MaxPool1D", (2, 3, 9), dict(pool_size=3, strides=2, ceil_mode=True)),
    ("MaxPool3D", (1, 2, 5, 6, 7), dict(pool_size=2, padding=1)),
    ("AvgPool1D", (2, 3, 9), dict(pool_size=3, strides=2, padding=1)),
    ("AvgPool2D", (2, 3, 8, 8), dict(pool_size=3, strides=2, padding=1,
                                      ceil_mode=True,
                                      count_include_pad=False)),
    ("AvgPool3D", (1, 2, 5, 6, 7), dict(pool_size=(2, 3, 2))),
    ("GlobalMaxPool1D", (2, 3, 9), {}),
    ("GlobalMaxPool2D", (2, 3, 5, 4), {}),
    ("GlobalMaxPool3D", (1, 2, 3, 4, 5), {}),
    ("GlobalAvgPool1D", (2, 3, 9), {}),
    ("GlobalAvgPool2D", (2, 3, 5, 4), {}),
    ("GlobalAvgPool3D", (1, 2, 3, 4, 5), {}),
    ("ReflectionPad2D", (2, 3, 5, 5), dict(padding=2)),
]


@pytest.mark.parametrize("case", CONV_LAYERS, ids=[c[0] for c in CONV_LAYERS])
def test_conv_and_pool_layers(case):
    name, shape, kw = case
    _check(lambda pkg, p: getattr(pkg.gluon.nn, name)(prefix=p, **kw),
           _x(1, shape), grad=True, what=name)


# -- activations ---------------------------------------------------------------

ACTIVATIONS = [("LeakyReLU", dict(alpha=0.1)), ("ELU", dict(alpha=0.7)),
               ("SELU", {}), ("GELU", {}), ("Swish", dict(beta=1.5)),
               ("PReLU", {})]


@pytest.mark.parametrize("case", ACTIVATIONS, ids=[c[0] for c in ACTIVATIONS])
def test_activations(case):
    name, kw = case
    _check(lambda pkg, p: getattr(pkg.gluon.nn, name)(prefix=p, **kw),
           _x(2, (2, 3, 4), -3, 3), grad=True, what=name)


def test_prelu_alpha_is_learned():
    """``alpha`` starts at its initializer's value and takes the
    gradient ``Σ min(x, 0) · ct``, as in the JAX package."""
    x = _x(3, (2, 3, 4), -3, 3)
    grads = []
    for pkg in (mx, mxt):
        blk = pkg.gluon.nn.PReLU(alpha_initializer=pkg.init.Constant(0.25),
                                 prefix="prelu_")
        ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
        blk.initialize(**ctx)
        assert blk.alpha.data().asnumpy().tolist() == [0.25]
        with pkg.autograd.record():
            y = blk(pkg.nd.array(x, **ctx)).sum()
        y.backward()
        grads.append(blk.alpha.grad().asnumpy())
    _close(grads[1], grads[0], "PReLU alpha gradient")
    _close(grads[1], [onp.minimum(x, 0).sum()], "PReLU alpha gradient")


# -- norms and lambdas ------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda pkg, p: pkg.gluon.nn.GroupNorm(num_groups=2, prefix=p),
    lambda pkg, p: pkg.gluon.nn.InstanceNorm(scale=True, prefix=p),
    lambda pkg, p: pkg.gluon.nn.InstanceNorm(axis=2, prefix=p),
    lambda pkg, p: pkg.gluon.nn.LayerNorm(axis=1, prefix=p)],
    ids=["GroupNorm", "InstanceNorm", "InstanceNorm_axis2", "LayerNorm"])
def test_norm_layers(make):
    init = mx.init.Mixed(["gamma", ".*"], [mx.init.Uniform(1.0),
                                            mx.init.Uniform(0.5)])
    _check(make, _x(4, (2, 4, 3, 5), -2, 3), grad=True, init=init)


@pytest.mark.parametrize("kind", ["Lambda", "HybridLambda"])
def test_lambdas(kind):
    x = _x(5, (2, 3))
    for fn in ("tanh", None):
        outs = []
        for pkg in (mx, mxt):
            if fn is None:
                f = (lambda F, a: F.relu(a) * 2) if kind == "HybridLambda" \
                    else (lambda a: pkg.nd.relu(a) * 2)
            else:
                f = fn
            blk = getattr(pkg.gluon.nn, kind)(f, prefix="lam_")
            ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
            outs.append(blk(pkg.nd.array(x, **ctx)).asnumpy())
        _close(outs[1], outs[0], "%s %s" % (kind, fn))
    with pytest.raises(ValueError):
        mxt.gluon.nn.Lambda(3)


def test_gluon_nn_has_every_name():
    names = set(mx.gluon.nn.__all__) | {"activations", "basic_layers",
                                        "conv_layers"}
    assert sorted(n for n in names if not hasattr(mxt.gluon.nn, n)) == []
    assert sorted(mxt.gluon.nn.__all__) == sorted(mx.gluon.nn.__all__)


# -- contrib layers -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["Concurrent", "HybridConcurrent"])
def test_concurrent(kind):
    def make(pkg, p):
        blk = getattr(pkg.gluon.contrib.nn if pkg is mxt else jcontrib.nn,
                      kind)(axis=1, prefix=p)
        with blk.name_scope():
            blk.add(pkg.gluon.nn.Dense(4))
            blk.add((tcontrib if pkg is mxt else jcontrib).nn.Identity())
            blk.add(pkg.gluon.nn.Dense(2, activation="tanh"))
        return blk
    _check(make, _x(6, (3, 5)), grad=True, what=kind)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_pixel_shuffle(ndim):
    shape = {1: (2, 6, 5), 2: (2, 12, 3, 4), 3: (1, 16, 2, 3, 2)}[ndim]
    factor = {1: 3, 2: (2, 3), 3: 2}[ndim]
    _check(lambda pkg, p: getattr(
        (tcontrib if pkg is mxt else jcontrib).nn,
        "PixelShuffle%dD" % ndim)(factor, prefix=p), _x(7, shape),
        what="PixelShuffle%dD" % ndim)


def test_sync_batch_norm_layer():
    """Training forwards (local statistics: no group is bound) and the
    moving averages after two steps, against the JAX layer."""
    x = _x(8, (4, 3, 5, 5), -1, 2)
    res = []
    for pkg, cnn in ((mx, jcontrib.nn), (mxt, tcontrib.nn)):
        blk = cnn.SyncBatchNorm(num_devices=1, momentum=0.8, prefix="sbn_")
        ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
        blk.initialize(**ctx)
        for _ in range(2):
            with pkg.autograd.record():
                y = blk(pkg.nd.array(x, **ctx))
        res.append([y.asnumpy(), blk.running_mean.data().asnumpy(),
                    blk.running_var.data().asnumpy()])
    for what, a, b in zip(("out", "running_mean", "running_var"), *res[::-1]):
        _close(a, b, "SyncBatchNorm " + what)


def test_sparse_embedding_raises():
    with pytest.raises(mxt.MXNetError, match="queue 1, item 9"):
        tcontrib.nn.SparseEmbedding(10, 4)


def test_contrib_nn_has_every_name():
    assert sorted(n for n in jcontrib.nn.__all__
                  if not hasattr(tcontrib.nn, n)) == []


# -- initializers --------------------------------------------------------------

def _init(pkg, init, shape, name="w_weight"):
    arr = pkg.nd.zeros(shape, ctx=mxt.cpu()) if pkg is mxt \
        else pkg.nd.zeros(shape)
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


def test_bilinear_exact():
    for shape in ((2, 1, 4, 4), (1, 3, 5, 3)):
        assert onp.array_equal(_init(mxt, mxt.init.Bilinear(), shape),
                               _init(mx, mx.init.Bilinear(), shape))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal(rand_type):
    for shape in ((6, 3, 2, 2), (20, 4)):
        mxt.random.seed(1)
        w = _init(mxt, mxt.init.Orthogonal(scale=1.5, rand_type=rand_type),
                  shape).reshape(shape[0], -1)
        j = _init(mx, mx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                  shape).reshape(shape[0], -1)
        for m in (w, j):
            g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            onp.testing.assert_allclose(g, 2.25 * onp.eye(len(g)),
                                        atol=2e-5)


def test_msra_prelu_scale():
    shape = (200, 50, 2, 2)
    fan = (50 * 4 + 200 * 4) / 2.0
    want = onp.sqrt(2.0 / (1 + 0.25 ** 2) / fan)
    mxt.random.seed(2)
    for pkg in (mxt, mx):
        w = _init(pkg, pkg.init.MSRAPrelu(), shape)
        assert abs(w.std() / want - 1) < 0.05 and abs(w.mean()) < 0.05 * want


def test_dumps_and_create_roundtrip():
    for make in (lambda p: p.init.Xavier(rnd_type="gaussian", magnitude=2),
                 lambda p: p.init.Normal(0.02), lambda p: p.init.Uniform(0.3),
                 lambda p: p.init.Orthogonal(), lambda p: p.init.MSRAPrelu(),
                 lambda p: p.init.LSTMBias(2.0)):
        s = make(mxt).dumps()
        assert s == make(mx).dumps()
        again = mxt.init.create(s)
        assert type(again) is type(make(mxt)) and again.dumps() == s


def test_mixed_and_load():
    shape = (3, 4)
    src = {"arg:a_weight": _x(10, shape)}
    for pkg in (mxt, mx):
        load = pkg.init.Load(src, default_init=pkg.init.One())
        assert onp.array_equal(_init(pkg, load, shape, "a_weight"),
                               src["arg:a_weight"])
        assert (_init(pkg, load, shape, "b_weight") == 1).all()
        with pytest.raises(ValueError):
            _init(pkg, pkg.init.Load(src), (2, 2), "a_weight")
        mixed = pkg.init.Mixed(["a_.*", ".*"],
                               [pkg.init.Constant(3.0), pkg.init.Zero()])
        assert (_init(pkg, mixed, shape, "a_weight") == 3).all()
        assert (_init(pkg, mixed, shape, "z_weight") == 0).all()
        with pytest.raises(ValueError):
            _init(pkg, pkg.init.Mixed(["x"], [pkg.init.One()]), shape,
                  "a_weight")


# -- parameters, files, utilities ----------------------------------------------

def test_constant_and_list_data():
    for pkg in (mx, mxt):
        ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
        pd = pkg.gluon.ParameterDict("pd_")
        c = pd.get_constant("c", [[1.0, 2.0], [3.0, 4.0]])
        assert pd.get_constant("c") is c and c.grad_req == "null"
        c.initialize(**ctx)
        assert c.data().asnumpy().tolist() == [[1.0, 2.0], [3.0, 4.0]]
        assert str(c.data().dtype).endswith("float32")
        assert [d.asnumpy().tolist() for d in c.list_data()] == \
            [[[1.0, 2.0], [3.0, 4.0]]]
        with pytest.raises(KeyError):
            pd.get_constant("missing")


def test_parameter_dict_files_cross_packages(tmp_path):
    def make(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="pdf_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(3, in_units=4),
                    pkg.gluon.nn.BatchNorm(in_channels=3))
        return net
    jnet, tnet = make(mx), make(mxt)
    jnet.initialize(mx.init.Xavier())
    with mxt.cpu():
        tnet.initialize(mxt.init.Uniform(1.0))
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.collect_params().save(jfile, strip_prefix="pdf_")
    tnet.collect_params().save(tfile, strip_prefix="pdf_")
    tvals = {k: p.data().asnumpy() for k, p in tnet.collect_params().items()}
    jvals = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    with mxt.cpu():
        tnet.collect_params().load(jfile, restore_prefix="pdf_")
    jnet.collect_params().load(tfile, restore_prefix="pdf_")
    for k in jvals:
        assert onp.array_equal(tnet.collect_params()[k].data().asnumpy(),
                               jvals[k])
        assert onp.array_equal(jnet.collect_params()[k].data().asnumpy(),
                               tvals[k])
    with pytest.raises(ValueError):
        tnet.collect_params().save(tfile, strip_prefix="other_")
    with pytest.raises(AssertionError):
        tnet.collect_params().load(tfile)


@pytest.mark.parametrize("even", [True, False])
def test_split_data_and_load(even):
    x = _x(11, (7, 3)) if not even else _x(11, (8, 3))
    for n in (1, 2, 3):
        if even and 8 % n:
            with pytest.raises(ValueError):
                mxt.gluon.split_data(mxt.nd.array(x, ctx=mxt.cpu()), n)
            continue
        got = mxt.gluon.split_data(mxt.nd.array(x, ctx=mxt.cpu()), n,
                                   even_split=even)
        want = mx.gluon.split_data(mx.nd.array(x), n, even_split=even)
        assert [g.asnumpy().tolist() for g in got] == \
            [w.asnumpy().tolist() for w in want]
    parts = mxt.gluon.split_and_load(x, [mxt.cpu(), mxt.cpu(1)],
                                     even_split=False)
    assert sum(p.shape[0] for p in parts) == x.shape[0]
    assert all(p.context.device_type == "cpu" for p in parts)


def test_summary_and_export(tmp_path, capsys):
    def make(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="sum_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1),
                    pkg.gluon.nn.GlobalAvgPool2D(), pkg.gluon.nn.Dense(2))
        return net
    x = _x(12, (1, 3, 6, 6))
    jnet, tnet = make(mx), make(mxt)
    jnet.initialize()
    jnet.summary(mx.nd.array(x))
    want = capsys.readouterr().out
    with mxt.cpu():
        tnet.initialize()
        tnet.summary(mxt.nd.array(x))
    got = capsys.readouterr().out
    assert got == want
    assert "Total params: %d" % (4 * 3 * 9 + 4 + 2 * 4 + 2) in got
    fname = tnet.export(str(tmp_path / "net"), epoch=3)
    assert fname.endswith("net-0003.params")
    jnet.load_parameters(fname)
    for k, p in tnet._collect_params_with_prefix().items():
        assert onp.array_equal(
            jnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy())
