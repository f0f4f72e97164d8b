"""Port parity: mixed precision (``contrib.amp``) of ``mxnet_tpu_torch``
against the JAX package's, on the CPU, and the integer softmax.

Every test turns AMP off again in both packages (the ``amp_off``
fixture), and every JAX block is built under an explicit prefix.

- The cast policy: for each list (target, float32, widest, conditional)
  and both target dtypes, the output dtype and values of an op of the list
  against the JAX package's: the same dtype, values within an ulp of the
  dtype (the same inputs rounded once); 2 ulps of the largest value where
  a 16-bit op sums (one framework rounds the product and the bias sum
  twice, the other once), 8 float32 ulps of it where a float32 op sums
  (in another order).
- ``amp_cast``, ``all_finite`` and ``multi_all_finite``: the same values.
- The ``LossScaler``: the JAX package's scales exactly, over overflows and
  clean windows; the float16 Trainer skips the update on an inf gradient
  and halves the scale, in both packages.
- ``convert_hybrid_block``: a hybridized block's graph is dropped and the
  next call runs in the target dtype, as in the JAX package.
- One masked-LM step of ``bert_small`` (2 layers, 128 units, 4 heads,
  97 words, batch 2 x 128 with valid lengths (128, 65), 5 masked
  positions a row) under ``amp.init("float16")`` and
  ``amp.init("bfloat16")``, through ``record``, ``scale_loss``,
  ``backward`` and ``Trainer("adam")`` with ``init_trainer``, from the same
  float32 weights, at the default loss scale of 2**16.  The loss (the
  float32 mean, ``mean`` being a float32 op, of the 16-bit row losses)
  within 2 of the 16-bit type's ulps (rel 2e-3 for float16, 1.6e-2 for
  bf16); the gradients (float32 buffers, scaled) within a relative L2
  error of 1e-2 (float16) and 5e-2 (bf16) over all parameters: the two
  frameworks round the same ops' outputs to the 16-bit type, but XLA's CPU
  fusions keep float32 inside a fusion where torch rounds each op, so
  single roundings differ by an ulp; the updated float32 weights within lr
  / 5 wherever the two gradients agree within half of the JAX one (one
  Adam step moves a weight by lr g / (|g| + eps)), and within 2 lr
  everywhere (a gradient near 0 may change sign); the loss scale, the
  scaler's state and the weights' and the Adam state's dtypes exactly.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.utils import load_jax_params

ULP = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
DTYPES = ("float16", "bfloat16")


@pytest.fixture(autouse=True)
def amp_off():
    yield
    jamp.disable()
    tamp.disable()


def _dt(dtype):
    return str(dtype).replace("torch.", "")


def _both(fn_jax, fn_port):
    """The JAX output and the port's, as (dtype name, float64 array)."""
    j = fn_jax()
    with mxt.cpu():
        p = fn_port()
    return ((_dt(j.dtype), onp.asarray(j.astype("float32").asnumpy(),
                                       "float64")),
            (_dt(p.dtype), onp.asarray(p.astype("float32").asnumpy(),
                                       "float64")))


def _close(j, p, ulps=1, whole=False):
    """The same dtype, and values within ``ulps`` of the dtype's ulps of
    each value (``whole``: of the largest value, for sums whose terms
    cancel, where one framework rounds twice and the other once)."""
    (jdt, jv), (pdt, pv) = j, p
    assert jdt == pdt, (jdt, pdt)
    big = onp.maximum(abs(jv), abs(pv))
    tol = ulps * ULP[jdt] * (big.max() if whole else big) + 1e-7
    assert (abs(jv - pv) <= tol).all(), abs(jv - pv).max()
    return jdt


def _x(shape, seed, dtype="float32"):
    return onp.random.RandomState(seed).uniform(-2, 2, shape).astype(dtype)


@pytest.mark.parametrize("target", DTYPES)
def test_policy_casts_target_ops(target):
    x, w, b = _x((4, 8), 0), _x((3, 8), 1), _x((3,), 2)
    jamp.init(target_dtype=target)
    tamp.init(target_dtype=target)
    dt = _close(*_both(
        lambda: mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w),
                                     mx.nd.array(b), num_hidden=3),
        lambda: mxt.nd.FullyConnected(mxt.nd.array(x), mxt.nd.array(w),
                                      mxt.nd.array(b), num_hidden=3)),
        ulps=2, whole=True)
    assert dt == target
    a, c = _x((2, 3, 4), 3), _x((2, 4, 5), 4)
    assert _close(*_both(
        lambda: mx.nd.batch_dot(mx.nd.array(a), mx.nd.array(c)),
        lambda: mxt.nd.batch_dot(mxt.nd.array(a), mxt.nd.array(c))),
        ulps=2, whole=True) == target


@pytest.mark.parametrize("target", DTYPES)
def test_policy_keeps_fp32_ops(target):
    x = _x((4, 8), 5, "float32")
    jamp.init(target_dtype=target)
    tamp.init(target_dtype=target)
    for op in ("softmax", "sum"):
        dt = _close(*_both(
            lambda: getattr(mx.nd, op)(mx.nd.array(x).astype(target)),
            lambda: getattr(mxt.nd, op)(mxt.nd.array(x).astype(target))),
            ulps=8, whole=True)
        assert dt == "float32", op
    gamma, beta = _x((8,), 6), _x((8,), 7)
    dt = _close(*_both(
        lambda: mx.nd.LayerNorm(mx.nd.array(x).astype(target),
                                mx.nd.array(gamma), mx.nd.array(beta)),
        lambda: mxt.nd.LayerNorm(mxt.nd.array(x).astype(target),
                                 mxt.nd.array(gamma), mxt.nd.array(beta))),
        ulps=8, whole=True)
    assert dt == "float32"


@pytest.mark.parametrize("target", DTYPES)
def test_policy_widest_and_conditional_ops(target):
    cond = (_x((6,), 8) > 0).astype("float32")
    a, b = _x((6,), 9), _x((6,), 10)
    jamp.init(target_dtype=target)
    tamp.init(target_dtype=target)
    # where: a 16-bit and a float32 operand meet in float32
    assert _close(*_both(
        lambda: mx.nd.where(mx.nd.array(cond), mx.nd.array(a).astype(target),
                            mx.nd.array(b)),
        lambda: mxt.nd.where(mxt.nd.array(cond),
                             mxt.nd.array(a).astype(target),
                             mxt.nd.array(b)))) == "float32"
    # one dtype among the floating operands: no cast
    assert _close(*_both(
        lambda: mx.nd.where(mx.nd.array(cond).astype(target),
                            mx.nd.array(a).astype(target),
                            mx.nd.array(b).astype(target)),
        lambda: mxt.nd.where(mxt.nd.array(cond).astype(target),
                             mxt.nd.array(a).astype(target),
                             mxt.nd.array(b).astype(target)))) == target
    # Activation(softrelu) and LeakyReLU(selu) run in float32, the other
    # act_types in the dtype they are given
    for op, act in (("Activation", "softrelu"), ("LeakyReLU", "selu"),
                    ("Activation", "relu")):
        dt = _close(*_both(
            lambda: getattr(mx.nd, op)(mx.nd.array(a).astype(target),
                                       act_type=act),
            lambda: getattr(mxt.nd, op)(mxt.nd.array(a).astype(target),
                                        act_type=act)), ulps=2)
        assert dt == ("float32" if act != "relu" else target), (op, act)


def test_policy_leaves_integer_inputs_and_unlisted_ops():
    jamp.init(target_dtype="float16")
    tamp.init(target_dtype="float16")
    ids = onp.array([[0, 2], [1, 3]], "float32")
    w = _x((4, 3), 11)
    # Embedding is in no list: float32 weights give float32 rows
    assert _close(*_both(
        lambda: mx.nd.Embedding(mx.nd.array(ids), mx.nd.array(w),
                                input_dim=4, output_dim=3),
        lambda: mxt.nd.Embedding(mxt.nd.array(ids), mxt.nd.array(w),
                                 input_dim=4, output_dim=3))) == "float32"
    # an int32 array passes a float32 op as it is (softmax then promotes)
    x = onp.array([[1, 2, 3]], "int32")
    j, p = _both(lambda: mx.nd.softmax(mx.nd.array(x, dtype="int32")),
                 lambda: mxt.nd.softmax(mxt.nd.array(x, dtype="int32")))
    assert j[0] == p[0] == "float32"
    onp.testing.assert_allclose(p[1], j[1], rtol=1e-6)


def test_casts_are_differentiable_into_float32_weights():
    """The policy's cast runs inside the recorded op: the float32 weight of
    a float16 FullyConnected gets a float32 gradient, the JAX package's."""
    x, w = _x((4, 8), 12), _x((3, 8), 13)
    jamp.init(target_dtype="float16")
    tamp.init(target_dtype="float16")
    jw = mx.nd.array(w)
    jw.attach_grad()
    with jautograd.record():
        jy = mx.nd.FullyConnected(mx.nd.array(x), jw, no_bias=True,
                                  num_hidden=3).sum()
    jy.backward()
    with mxt.cpu():
        tw = mxt.nd.array(w)
        tw.attach_grad()
        with mxt.autograd.record():
            ty = mxt.nd.FullyConnected(mxt.nd.array(x), tw, no_bias=True,
                                       num_hidden=3).sum()
        ty.backward()
    assert _dt(tw.grad.dtype) == _dt(jw.grad.dtype) == "float32"
    onp.testing.assert_allclose(tw.grad.asnumpy(), jw.grad.asnumpy(),
                                rtol=2 * ULP["float16"])


def test_integer_softmax_promotes_to_float32():
    """``nd.softmax`` of an int32 array: float32 as ``jax.nn.softmax``
    gives it (rel 1e-6); with a temperature too."""
    x = onp.array([[1, 2, 3]], "int32")
    got = mxt.nd.softmax(mxt.nd.array(x, ctx=mxt.cpu(), dtype="int32"))
    want = mx.nd.softmax(mx.nd.array(x, dtype="int32"))
    assert _dt(got.dtype) == _dt(want.dtype) == "float32"
    onp.testing.assert_allclose(got.asnumpy(), [[0.09003057, 0.24472848,
                                                 0.66524094]], rtol=1e-6)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)
    got = mxt.nd.softmax(mxt.nd.array(x, ctx=mxt.cpu(), dtype="int32"),
                         temperature=2.0)
    want = mx.nd.softmax(mx.nd.array(x, dtype="int32"), temperature=2.0)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ("float16", "bfloat16", "float32"))
def test_amp_cast_matches_jax(dtype):
    x = _x((3, 5), 14) * 1000
    j, p = _both(lambda: mx.nd.amp_cast(mx.nd.array(x), dtype=dtype),
                 lambda: mxt.nd.amp_cast(mxt.nd.array(x), dtype=dtype))
    assert j[0] == p[0] == dtype
    onp.testing.assert_array_equal(p[1], j[1])


@pytest.mark.parametrize("bad", (None, onp.inf, -onp.inf, onp.nan))
def test_all_finite_and_multi_all_finite_match_jax(bad):
    a = _x((3, 4), 15)
    b = _x((5,), 16).astype("float16")
    if bad is not None:
        b[2] = bad
    want = 0.0 if bad is not None else 1.0
    with mxt.cpu():
        for jv, tv in (
                (mx.nd.all_finite(mx.nd.array(b, dtype="float16")),
                 mxt.nd.all_finite(mxt.nd.array(b, dtype="float16"))),
                (mx.nd.multi_all_finite(mx.nd.array(a),
                                        mx.nd.array(b, dtype="float16"),
                                        num_arrays=2),
                 mxt.nd.multi_all_finite(mxt.nd.array(a),
                                         mxt.nd.array(b, dtype="float16"),
                                         num_arrays=2))):
            assert _dt(tv.dtype) == _dt(jv.dtype) == "float32"
            assert tv.shape == jv.shape == (1,)
            onp.testing.assert_array_equal(tv.asnumpy(), jv.asnumpy())
            assert float(tv.asnumpy()[0]) == want


def test_loss_scaler_dynamics_match_jax():
    """The same sequence of overflows and clean steps gives the JAX
    package's scales, exactly."""
    js = jamp.LossScaler(init_scale=1024.0, scale_factor=2.0, scale_window=3)
    ts = tamp.LossScaler(init_scale=1024.0, scale_factor=2.0, scale_window=3)
    bad = onp.array([onp.inf, 1.0], "float32")
    good = onp.array([1.0, 2.0], "float32")
    pattern = [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1] + [1] * 12
    jscales, tscales = [], []
    with mxt.cpu():
        for overflow in pattern:
            g = bad if overflow else good
            jo = js.has_overflow([mx.nd.array(good), mx.nd.array(g)])
            to = ts.has_overflow([mxt.nd.array(good), mxt.nd.array(g)])
            assert jo == to == bool(overflow)
            js.update_scale(jo)
            ts.update_scale(to)
            jscales.append(js.loss_scale)
            tscales.append(ts.loss_scale)
    assert tscales == jscales
    assert tscales[-1] == 1.0           # never below 1
    assert not ts.has_overflow([])


def test_fp16_trainer_skips_update_on_overflow():
    """The JAX package's test_fp16_trainer_skips_update_on_overflow in both
    packages: an inf gradient skips the update and halves the scale; a
    clean step (one row, so that the float16 weight gradient, 2**15, does
    not overflow) then updates both alike."""
    jamp.init(target_dtype="float16")
    tamp.init(target_dtype="float16")
    jnet = jgluon.nn.Dense(1, in_units=3, prefix="ampdense_")
    jnet.initialize(mx.init.Constant(1.0))
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    jamp.init_trainer(jtr)
    with mxt.cpu():
        tnet = tgluon.nn.Dense(1, in_units=3, prefix="ampdense_")
        tnet.initialize(mxt.init.Constant(1.0))
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                             {"learning_rate": 0.1})
        tamp.init_trainer(ttr)
    def jstep(poison):
        x = onp.ones((2 if poison else 1, 3), "float32")
        with jautograd.record():
            loss = jnet(mx.nd.array(x)).sum()
            with jamp.scale_loss(loss, jtr) as scaled:
                scaled.backward()
        if poison:
            w = [p for p in jtr._params if p.grad_req != "null"][0]
            w.grad()[:] = onp.inf
        jtr.step(1)

    def tstep(poison):
        x = onp.ones((2 if poison else 1, 3), "float32")
        with mxt.cpu():
            with mxt.autograd.record():
                loss = tnet(mxt.nd.array(x)).sum()
                with tamp.scale_loss(loss, ttr) as scaled:
                    scaled.backward()
            if poison:
                w = [p for p in ttr._params if p.grad_req != "null"][0]
                w.grad().astorch().fill_(float("inf"))
            ttr.step(1)

    def weights(net):
        return {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}
    before = weights(tnet)
    scale0 = ttr._amp_loss_scaler.loss_scale
    assert scale0 == jtr._amp_loss_scaler.loss_scale == 2.0 ** 16
    jstep(True)
    tstep(True)
    for k, w in weights(tnet).items():
        onp.testing.assert_array_equal(w, before[k])
        onp.testing.assert_array_equal(weights(jnet)[k], before[k])
    assert ttr._amp_loss_scaler.loss_scale == \
        jtr._amp_loss_scaler.loss_scale == scale0 / 2
    jstep(False)
    tstep(False)
    assert ttr._amp_loss_scaler.loss_scale == \
        jtr._amp_loss_scaler.loss_scale == scale0 / 2
    assert not ttr._amp_loss_scaler._has_overflow
    for k, w in weights(tnet).items():
        assert not onp.array_equal(w, before[k]), k
        onp.testing.assert_allclose(w, weights(jnet)[k], rtol=1e-6)


def test_unscale_divides_the_gradients_once():
    jamp.init(target_dtype="float16")
    tamp.init(target_dtype="float16")
    with mxt.cpu():
        net = tgluon.nn.Dense(2, in_units=3, prefix="ampunscale_")
        net.initialize(mxt.init.Constant(0.5))
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
        tamp.init_trainer(tr)
        with mxt.autograd.record():
            loss = net(mxt.nd.array(onp.ones((2, 3), "float32"))).sum()
            with tamp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        scale = tr._amp_loss_scaler.loss_scale
        assert tr._scale == 1.0 / scale
        g = net.weight.grad().asnumpy().copy()
        tamp.unscale(tr)
        onp.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                       g / scale)
        assert tr._scale == 1.0


def test_convert_symbol_and_model_name_the_symbol_wait():
    """The Symbol API's wait is over: both convert a graph, as the JAX
    package's do (tests/test_torch_module.py holds them to its graphs)."""
    with mxt.name.NameManager():
        s = mxt.sym.FullyConnected(mxt.sym.var("data"), num_hidden=2,
                                   name="fc")
    conv = tamp.convert_symbol(s)
    assert "fc_data_amp_cast_bfloat16" in conv.tojson()
    sym, args, aux = tamp.convert_model(s, {}, {})
    assert sym.tojson() == conv.tojson() and args == aux == {}


def test_public_names_match_jax():
    names = ("init", "init_trainer", "scale_loss", "unscale",
             "convert_model", "convert_symbol", "convert_hybrid_block",
             "list_bf16_ops", "list_fp16_ops", "list_fp32_ops",
             "is_initialized", "disable", "LossScaler")
    for n in names:
        assert hasattr(jamp, n) and hasattr(tamp, n), n
        assert hasattr(mxt.contrib.amp, n), n
    assert tamp.list_fp16_ops() == jamp.list_fp16_ops()
    assert tamp.list_bf16_ops() == jamp.list_bf16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()
    assert not tamp.is_initialized()
    tamp.init("float16")
    assert tamp.is_initialized()


@pytest.mark.parametrize("target", DTYPES)
def test_convert_hybrid_block_matches_jax(target):
    """A hybridized block converted: its graph is dropped, AMP is on, and
    the next call runs its Dense layers in the target dtype, as in the
    JAX package."""
    x = _x((4, 6), 17)
    jnet = jgluon.nn.HybridSequential(prefix="ampconv_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(5, activation="relu"), jgluon.nn.Dense(3))
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()
    jnet(mx.nd.array(x))
    w = {k: p.data().asnumpy()
         for k, p in jnet._collect_params_with_prefix().items()}
    with mxt.cpu():
        tnet = tgluon.nn.HybridSequential(prefix="ampconv_")
        with tnet.name_scope():
            tnet.add(tgluon.nn.Dense(5, activation="relu"),
                     tgluon.nn.Dense(3))
        tnet.initialize()
        tnet(mxt.nd.array(x))
        load_jax_params(tnet, w)
        tnet.hybridize()
        want32 = tnet(mxt.nd.array(x))
        assert _dt(want32.dtype) == "float32"
        assert tnet._cached_graph is not None
    jout = jamp.convert_hybrid_block(jnet, target_dtype=target)(
        mx.nd.array(x))
    assert jamp.is_initialized()
    with mxt.cpu():
        assert tamp.convert_hybrid_block(tnet, target_dtype=target) is tnet
        assert tamp.is_initialized() and tnet._cached_graph is None
        tout = tnet(mxt.nd.array(x))
    assert _close((_dt(jout.dtype), onp.asarray(
        jout.astype("float32").asnumpy(), "float64")),
        (_dt(tout.dtype), onp.asarray(tout.astype("float32").asnumpy(),
                                      "float64")), ulps=4) == target


# -- one bert_small MLM step under AMP ----------------------------------------

CFG = dict(num_layers=2, units=128, hidden_size=256, vocab_size=97, max_length=128, dropout=0.0, use_pooler=False,
           use_decoder=True)
VOCAB = CFG["vocab_size"]
SEQ, LENS, N_PRED = 128, (128, 65), 5
LR = 1e-4
LOSS_RTOL = {"float16": 2e-3, "bfloat16": 1.6e-2}
GRAD_REL_L2 = {"float16": 1e-2, "bfloat16": 5e-2}
# the one parameter a batch without token types never reaches
UNREACHED = {"type_embed.weight"}


def _inputs(seed):
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, VOCAB, (2, SEQ)).astype("float32")
    pos = onp.sort(onp.stack([rs.choice(min(LENS), N_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, VOCAB, (2, N_PRED)).astype("float32")
    return tokens, onp.array(LENS, "int32"), pos, labels


_STEPS = {}


def _amp_steps(target, monkeypatch):
    """One AMP MLM step in each package from the same float32 weights:
    {"jax"|"port": (loss, {name: grad}, {name: weight}, trainer)} and the
    weights before, computed once a dtype."""
    if target in _STEPS:
        return _STEPS[target]
    tokens, lens, pos, labels = _inputs(0)
    # AMP on before the first forward, which completes the deferred
    # shapes: the JAX package compiles each op once, in the target dtype
    jamp.init(target_dtype=target)
    mx.random.seed(3)
    jnet = jbert.bert_small(prefix="ampbert_", **CFG)
    jnet.initialize(mx.init.Xavier())
    # one jitted program for the forward and one for its backward, the
    # casts traced into them (op by op, the JAX package compiles each op
    # and each op's backward for seconds)
    jnet.hybridize()
    jargs = (mx.nd.array(tokens), None, None,
             mx.nd.array(lens, dtype="int32"), mx.nd.array(pos, dtype="int32"))
    jnet(*jargs)
    w0 = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", {"learning_rate": LR})
    jamp.init_trainer(jtr)
    jce = jgluon.loss.SoftmaxCrossEntropyLoss(prefix="ampce_")
    with jautograd.record():
        _, logits = jnet(*jargs)
        jloss = jce(logits.reshape(-1, VOCAB),
                    mx.nd.array(labels).reshape(-1)).mean()
        with jamp.scale_loss(jloss, jtr) as scaled:
            scaled.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    jtr.step(1, ignore_stale_grad=True)
    jw1 = {k: p.data().asnumpy()
           for k, p in jnet._collect_params_with_prefix().items()}
    jamp.disable()

    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    with mxt.cpu():
        net = tbert.bert_small(**CFG)
        net.initialize()
        load_jax_params(net, w0)
        tamp.init(target_dtype=target)
        tr = tgluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": LR})
        tamp.init_trainer(tr)
        ce = tgluon.loss.SoftmaxCrossEntropyLoss()
        with mxt.autograd.record():
            _, logits = net(mxt.nd.array(tokens), None, None,
                            mxt.nd.array(lens, dtype="int32"),
                            mxt.nd.array(pos, dtype="int32"))
            loss = ce(logits.reshape(-1, VOCAB),
                      mxt.nd.array(labels).reshape(-1)).mean()
            with tamp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in net._collect_params_with_prefix().items()}
        tr.step(1, ignore_stale_grad=True)
        w1 = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    tamp.disable()
    _STEPS[target] = (w0, (jloss, jgrads, jw1, jtr), (loss, grads, w1, tr))
    return _STEPS[target]


@pytest.mark.parametrize("target", DTYPES)
def test_bert_small_amp_step_loss_and_scale_match_jax(target, monkeypatch):
    w0, (jloss, _, _, jtr), (loss, _, _, tr) = _amp_steps(target,
                                                         monkeypatch)
    assert _dt(loss.dtype) == _dt(jloss.dtype) == "float32"
    want = float(jloss.astype("float32").asnumpy())
    got = float(loss.astype("float32").asnumpy())
    assert abs(got - want) <= LOSS_RTOL[target] * abs(want), (got, want)
    js, ts = jtr._amp_loss_scaler, tr._amp_loss_scaler
    assert ts.loss_scale == js.loss_scale
    assert ts._unskipped == js._unskipped
    assert ts._has_overflow is js._has_overflow is False


@pytest.mark.parametrize("target", DTYPES)
def test_bert_small_amp_step_gradients_match_jax(target, monkeypatch):
    _, (_, jgrads, _, _), (_, grads, _, _) = _amp_steps(target, monkeypatch)
    assert set(grads) == set(jgrads)
    err2 = ref2 = 0.0
    for k, g in grads.items():
        assert _dt(g.dtype) == _dt(jgrads[k].dtype) == "float32", k
        assert onp.isfinite(g).all(), k
        if k in UNREACHED:
            assert not g.any() and not jgrads[k].any(), k
            continue
        d = g.astype("float64") - jgrads[k]
        err2 += float((d * d).sum())
        ref2 += float((jgrads[k].astype("float64") ** 2).sum())
    assert (err2 / ref2) ** 0.5 <= GRAD_REL_L2[target], (err2 / ref2) ** 0.5


@pytest.mark.parametrize("target", DTYPES)
def test_bert_small_amp_step_updates_match_jax(target, monkeypatch):
    w0, (_, jgrads, jw1, _), (_, grads, w1, tr) = _amp_steps(target,
                                                             monkeypatch)
    for k, w in w1.items():
        assert _dt(w.dtype) == "float32", k
        if k in UNREACHED:
            onp.testing.assert_array_equal(w, w0[k])
            continue
        assert not onp.array_equal(w, w0[k]), k
        diff = abs(w.astype("float64") - jw1[k])
        assert (diff <= 2.001 * LR).all(), k
        agree = abs(grads[k] - jgrads[k]) <= 0.5 * abs(jgrads[k])
        assert (diff[agree] <= LR / 5).all(), (k, diff[agree].max())
    for st in tr._updater.states.values():
        assert all(_dt(s.dtype) == "float32" for s in st)
