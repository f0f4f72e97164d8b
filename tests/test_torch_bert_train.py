"""Port parity: one BERT masked-LM pretraining step of ``mxnet_tpu_torch``
against the JAX package's ``DataParallelStep``, on the CPU, from the same
weights and data.

``bert_small`` as in tests/test_torch_bert.py (2 layers, 64 units, 4
heads, 97 words), without the pooler, with ``MXNET_FUSED_LAYERNORM=1``:
batch 2 x 128 with valid lengths (128, 65) and 5 sorted masked positions
a row.  The loss is bench.py's ``MLMLoss``: softmax cross entropy over the
logits of the masked positions, the mean over their rows taken as
``DataParallelStep`` takes it.  The port runs ``autograd.record``,
``backward`` and ``gluon.Trainer("adam")``, its attention and LayerNorm
through the kernels' autograd Functions (their plain versions on the
CPU); the JAX package composes both on the CPU.

The port's ``parallel.DataParallelStep`` (no mesh) takes the same step as
the JAX package's, in one call, with the tolerances below.

float32: the loss within rel 1e-5; each parameter's gradient, read from
Adam's first moment (``(1 - beta1) * g`` after one step), within a
relative L2 error of 1e-4 (the same arithmetic summed in another order
through 2 layers and the 97-word decoder); each updated weight within
lr / 50 of the JAX package's.  One Adam step moves a weight by about
``lr * g / (|g| + 3e-7)``, so only where |g| is below about 1e-6 can a
difference in g show in the weight at all, and there by lr * |dg| / 3e-7
at most.  bfloat16: the dtypes of the parameters, the gradients, the Adam
state and the loss against the JAX step's, and the loss within rel 2e-2.
"""
import numpy as onp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.utils import load_jax_params
from test_torch_bert import SMALL

CFG = dict(SMALL, use_pooler=False)
VOCAB = CFG["vocab_size"]
SEQ, LENS, N_PRED = 128, (128, 65), 5
LR = 1e-4
BETA1 = 0.9
# the one parameter a batch without token types never reaches
UNREACHED = {"type_embed.weight"}


def _inputs(seed):
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, VOCAB, (2, SEQ)).astype("float32")
    pos = onp.sort(onp.stack([rs.choice(min(LENS), N_PRED, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    labels = rs.randint(0, VOCAB, (2, N_PRED)).astype("float32")
    return tokens, onp.array(LENS, "int32"), pos, labels


class _JaxMLMLoss(jgluon.loss.Loss):
    """bench.py's MLMLoss."""

    def __init__(self):
        super().__init__(weight=None, batch_axis=0)
        self._ce = jgluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outputs, lab):
        _, logits = outputs
        return self._ce(logits.reshape(-1, VOCAB), lab.reshape(-1))


_JAX_STEPS = {}


def _jax_step(dtype, inputs):
    """The JAX net, its weights before the step, and after one step: the
    loss, the weights and each parameter's Adam state (m, v), by name
    (computed once a dtype: the inputs are a dtype's own)."""
    if dtype not in _JAX_STEPS:
        _JAX_STEPS[dtype] = _jax_step_uncached(dtype, inputs)
    return _JAX_STEPS[dtype]


def _jax_step_uncached(dtype, inputs):
    tokens, lens, pos, labels = inputs
    mx.random.seed(3)
    net = jbert.bert_small(**CFG)
    net.initialize(mx.init.Xavier())
    vl = mx.nd.array(lens, dtype="int32")
    mp = mx.nd.array(pos, dtype="int32")
    net(mx.nd.array(tokens), None, None, vl, mp)
    w0 = {k: p.data().asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    if dtype != "float32":
        net.cast(dtype)
    step = mx.parallel.DataParallelStep(
        net, _JaxMLMLoss(), mx.optimizer.Adam(learning_rate=LR), mesh=None)
    loss = step((mx.nd.array(tokens), None, None, vl, mp),
                mx.nd.array(labels))
    names = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    states = {names[id(step._params[i])]: step._opt_states[slot]
              for slot, i in enumerate(step._trainable)}
    w1 = {k: p.data() for k, p in net._collect_params_with_prefix().items()}
    return w0, loss, w1, states


def _port_step(dtype, w0, inputs, monkeypatch):
    """The same step through the port's Gluon entry points: the loss, the
    net and the trainer after it."""
    tokens, lens, pos, labels = inputs
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    net = tbert.bert_small(**CFG)
    with mxt.cpu():
        net.initialize()
        load_jax_params(net, w0)
        if dtype != "float32":
            net.cast(dtype)
        trainer = tgluon.Trainer(net.collect_params(), "adam",
                                 {"learning_rate": LR})
        ce = tgluon.loss.SoftmaxCrossEntropyLoss()
        with mxt.autograd.record():
            _, logits = net(mxt.nd.array(tokens), None, None,
                            mxt.nd.array(lens, dtype="int32"),
                            mxt.nd.array(pos, dtype="int32"))
            loss = ce(logits.reshape(-1, VOCAB),
                      mxt.nd.array(labels).reshape(-1)).mean()
        loss.backward()
        trainer.step(1, ignore_stale_grad=True)
    return loss, net, trainer


class _PortMLMLoss(tgluon.loss.Loss):
    """bench.py's MLMLoss, in the port."""

    def __init__(self):
        super().__init__(weight=None, batch_axis=0)
        self._ce = tgluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, outputs, lab):
        _, logits = outputs
        return self._ce(logits.reshape(-1, VOCAB), lab.reshape(-1))


def _port_dp_step(w0, inputs, monkeypatch):
    """The same step through the port's DataParallelStep (no mesh): the
    loss, the net and the step."""
    tokens, lens, pos, labels = inputs
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    net = tbert.bert_small(**CFG)
    with mxt.cpu():
        net.initialize()
        load_jax_params(net, w0)
        step = mxt.parallel.DataParallelStep(
            net, _PortMLMLoss(), mxt.optimizer.Adam(learning_rate=LR))
        loss = step((mxt.nd.array(tokens), None, None,
                     mxt.nd.array(lens, dtype="int32"),
                     mxt.nd.array(pos, dtype="int32")),
                    mxt.nd.array(labels))
    return loss, net, step


def _dt(dtype):
    """A dtype's name, whether numpy's, JAX's or torch's."""
    return str(dtype).replace("torch.", "")


def _port_states(net, trainer):
    index = {id(p): i for i, p in enumerate(trainer._params)}
    return {k: trainer._updater.states[index[id(p)]]
            for k, p in net._collect_params_with_prefix().items()
            if index[id(p)] in trainer._updater.states}


def test_bert_train_step_matches_jax_f32(monkeypatch):
    inputs = _inputs(0)
    w0, jloss, jw1, jstates = _jax_step("float32", inputs)
    loss, net, trainer = _port_step("float32", w0, inputs, monkeypatch)
    want = float(jloss.asnumpy())
    assert abs(float(loss.asnumpy()) - want) <= 1e-5 * abs(want)
    states = _port_states(net, trainer)
    assert set(states) == set(jstates) - UNREACHED
    params = net._collect_params_with_prefix()
    for k in UNREACHED:
        assert not params[k].grad().asnumpy().any()
        onp.testing.assert_array_equal(params[k].data().asnumpy(), w0[k])
        onp.testing.assert_array_equal(jw1[k].asnumpy(), w0[k])
    for k, (m, v) in states.items():
        g = params[k].grad().asnumpy()
        assert onp.isfinite(g).all(), k
        jm = onp.asarray(jstates[k][0])
        err = onp.linalg.norm(m.asnumpy() - jm) / onp.linalg.norm(jm)
        assert err <= 1e-4, (k, err)
        onp.testing.assert_allclose(m.asnumpy(), (1 - BETA1) * g,
                                    rtol=1e-6, atol=1e-12, err_msg=k)
        onp.testing.assert_allclose(params[k].data().asnumpy(),
                                    jw1[k].asnumpy(), rtol=0, atol=LR / 50,
                                    err_msg=k)
        assert not onp.array_equal(params[k].data().asnumpy(), w0[k]), k


def test_bert_train_step_dtypes_match_jax_bf16(monkeypatch):
    inputs = _inputs(1)
    w0, jloss, jw1, jstates = _jax_step("bfloat16", inputs)
    loss, net, trainer = _port_step("bfloat16", w0, inputs, monkeypatch)
    assert _dt(loss.dtype) == _dt(jloss.dtype) == "bfloat16"
    want = float(jloss.astype("float32").asnumpy())
    got = float(loss.astype("float32").asnumpy())
    assert abs(got - want) <= 2e-2 * abs(want), (got, want)
    states = _port_states(net, trainer)
    assert set(states) == set(jstates) - UNREACHED
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        want_dt = _dt(jw1[k].dtype)
        assert want_dt == "bfloat16", k
        assert _dt(p.data().dtype) == want_dt, k
        # jax.grad's cotangent takes the primal's dtype
        assert _dt(p.grad().dtype) == want_dt, k
        if k in states:
            assert [_dt(s.dtype) for s in states[k]] == \
                [_dt(s.dtype) for s in jstates[k]] == [want_dt] * 2, k


def test_bert_data_parallel_step_matches_jax_f32(monkeypatch):
    """The port's DataParallelStep against the JAX package's: the loss,
    each parameter's Adam first moment and the updated weights, with the
    tolerances of the Trainer's test above; the parameters' gradient
    buffers stay untouched, as the JAX step leaves them."""
    inputs = _inputs(0)
    w0, jloss, jw1, jstates = _jax_step("float32", inputs)
    loss, net, step = _port_dp_step(w0, inputs, monkeypatch)
    assert loss.shape == () and loss.context == mxt.cpu()
    want = float(jloss.asnumpy())
    assert abs(float(loss.asnumpy()) - want) <= 1e-5 * abs(want)
    params = net._collect_params_with_prefix()
    names = {id(p): k for k, p in params.items()}
    states = {names[id(step._params[i])]: step._opt_states[slot]
              for slot, i in enumerate(step._trainable)}
    assert set(states) == set(jstates)
    for k, (m, v) in states.items():
        assert not params[k].grad().asnumpy().any(), k
        jm = onp.asarray(jstates[k][0])
        if k in UNREACHED:
            assert not m.any() and not jm.any(), k
            onp.testing.assert_array_equal(params[k].data().asnumpy(), w0[k])
            continue
        err = onp.linalg.norm(m.numpy() - jm) / onp.linalg.norm(jm)
        assert err <= 1e-4, (k, err)
        onp.testing.assert_allclose(params[k].data().asnumpy(),
                                    jw1[k].asnumpy(), rtol=0, atol=LR / 50,
                                    err_msg=k)
