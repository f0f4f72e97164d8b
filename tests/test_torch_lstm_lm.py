"""Port parity: the LSTM language models of ``mxnet_tpu_torch`` trained
through ``parallel.DataParallelStep`` against the JAX package's step, on
the CPU, from the same weights and data.

* Config 4's model (``gluon/model_zoo/lm.py:LSTMLM``, built as
  ``bench.py:bench_lstm_lm`` builds it) at a narrow width (vocabulary 50,
  embedding = hidden 16, 2 layers, batch 4 x 6 tokens): one step of SGD
  (lr 1.0, ``rescale_grad = 1/4``) from the JAX net's weights, carried by
  structural name with ``load_jax_params``.  float32: the loss within rel
  1e-5 and the updated weights within rtol 1e-5, atol 1e-6.  bfloat16
  (``net.cast``): the loss within rel 1e-2, and each updated weight within
  4 bf16 ulps of its largest entry (4 * 2^-7 * max|w|).  The two packages
  round at different points: XLA's CPU backend fuses the softmax cross
  entropy's backward and rounds to bf16 only at the end of the fusion,
  torch after every op, and the LSTM's gates and carries differ as in
  tests/test_torch_rnn.py.  On this input the largest gap is 2.2 ulps,
  in ``fc.bias``, whose update is the closer of the two to the float32
  step's (relative L2 error 0.005 against the JAX package's 0.017).
* The word-LM example's model (``example/rnn/word_lm/train.py``:
  ``RNNModel``, tied weights, dropout 0) with its loss over every position
  and SGD (lr 20, ``clip_gradient = 0.25``): one step, float32, the same
  tolerance as above.
* The same model with dropout 0.2 on the example's synthetic corpus
  through ``LanguageModelDataset`` and a ``DataLoader``: the loss falls
  over 30 steps (the mean of the last 5 below the mean of the first 5).

Every JAX-package block, the losses too, is built under an explicit
prefix, so no global name counter of the JAX package moves.
"""
import importlib.util
import os

import numpy as onp
import pytest

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.contrib.data.text import LanguageModelDataset
from mxnet_tpu_torch.gluon.model_zoo.lm import LSTMLM, RNNModel, SeqCELoss
from mxnet_tpu_torch.gluon.utils import load_jax_params

V, E, LAYERS, N, T = 50, 16, 2, 4, 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-6)


def _example():
    spec = importlib.util.spec_from_file_location(
        "word_lm_train", os.path.join(REPO, "example", "rnn", "word_lm",
                                      "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_lstm_lm():
    """bench.py:bench_lstm_lm's LM class, at the narrow width."""
    gluon, nn, rnn = mx.gluon, mx.gluon.nn, mx.gluon.rnn

    class LM(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(V, E)
                self.lstm = rnn.LSTM(E, num_layers=LAYERS, layout="NTC")
                self.fc = nn.Dense(V, flatten=False)

        def hybrid_forward(self, F, x):
            return self.fc(self.lstm(self.embed(x)))
    return LM(prefix="lm_")


def _jax_seq_ce(vocab):
    class SeqCELoss(mx.gluon.loss.Loss):
        def __init__(self):
            super().__init__(weight=None, batch_axis=0, prefix="seqce_")
            self._ce = mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="ce_")

        def hybrid_forward(self, F, logits, lab):
            return self._ce(logits.reshape(-1, vocab), lab.reshape(-1))
    return SeqCELoss()


def _batch(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, V, (N, T)).astype("float32"),
            rs.randint(0, V, (N, T)).astype("float32"))


def _jax_step(net, loss, opt, x, y, dtype):
    mx.random.seed(0)
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(x))
    for p in net.collect_params().values():
        # uncommitted, as the step wants them
        p._data._data = jax.numpy.asarray(p._data._data)
    w0 = {k: p.data().asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    if dtype != "float32":
        net.cast(dtype)
    step = mx.parallel.DataParallelStep(net, loss, opt, mesh=None)
    lval = float(step(mx.nd.array(x), mx.nd.array(y))
                 .astype("float32").asnumpy())
    w1 = {k: p.data().astype("float32").asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    return w0, lval, w1


def _port_step(net, loss, opt, w0, x, y, dtype):
    with mxt.cpu():
        net.initialize()
        net(mxt.nd.array(x))
        load_jax_params(net, w0)
        if dtype != "float32":
            net.cast(dtype)
        step = mxt.parallel.DataParallelStep(net, loss, opt, mesh=None)
        lval = float(step(mxt.nd.array(x), mxt.nd.array(y))
                     .astype("float32").asnumpy())
    w1 = {k: p.data().astype("float32").asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    return lval, w1


def _check(got_loss, got_w, want_loss, want_w, dtype):
    assert sorted(got_w) == sorted(want_w)
    if dtype == "float32":
        assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
        for k in want_w:
            onp.testing.assert_allclose(got_w[k], want_w[k], err_msg=k,
                                        **F32)
        return
    assert abs(got_loss - want_loss) <= 1e-2 * abs(want_loss)
    for k in want_w:
        ulp = 2.0 ** -7 * onp.abs(want_w[k]).max()
        onp.testing.assert_allclose(got_w[k], want_w[k], rtol=0,
                                    atol=4 * ulp, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config4_lstm_lm_step_matches_jax(dtype):
    x, y = _batch(0)

    def sgd(pkg):
        return pkg.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0 / N)
    w0, jloss, jw = _jax_step(
        _jax_lstm_lm(), mx.gluon.loss.SoftmaxCrossEntropyLoss(prefix="ce_"),
        sgd(mx), x, y, dtype)
    assert "lstm.l1_h2h_weight" in w0
    tloss, tw = _port_step(LSTMLM(V, E, LAYERS, prefix="lm_"),
                           mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                           sgd(mxt), w0, x, y, dtype)
    _check(tloss, tw, jloss, jw, dtype)


def test_word_lm_tied_clipped_step_matches_jax():
    x, y = _batch(1)
    ex = _example()

    def sgd(pkg):
        return pkg.optimizer.SGD(learning_rate=20.0, clip_gradient=0.25)
    jnet = ex.RNNModel(V, E, E, LAYERS, dropout=0.0, tied=True,
                       prefix="wlm_")
    w0, jloss, jw = _jax_step(jnet, _jax_seq_ce(V), sgd(mx), x, y,
                              "float32")
    # the head's weight is the embedding's
    assert onp.array_equal(w0["head.weight"], w0["embed.weight"])
    tnet = RNNModel(V, E, E, LAYERS, dropout=0.0, tied=True, prefix="wlm_")
    tloss, tw = _port_step(tnet, SeqCELoss(V), sgd(mxt), w0, x, y,
                           "float32")
    assert tnet.head.weight is tnet.embed.weight
    _check(tloss, tw, jloss, jw, "float32")


def test_word_lm_with_dropout_learns_the_synthetic_corpus(tmp_path):
    path = str(tmp_path / "corpus.txt")
    _example()._synthetic_corpus(path, n_tokens=6000, vocab=40, seed=0)
    data = LanguageModelDataset(path, seq_len=10)
    vocab = len(data.vocabulary)
    with mxt.cpu():
        mxt.random.seed(0)
        net = RNNModel(vocab, E, E, LAYERS, dropout=0.2, tied=True,
                       prefix="wlm_")
        net.initialize(mxt.init.Xavier())
        net(mxt.nd.zeros((8, 10)))
        step = mxt.parallel.DataParallelStep(
            net, SeqCELoss(vocab),
            mxt.optimizer.SGD(learning_rate=20.0, clip_gradient=0.25),
            mesh=None)
        loader = mxt.gluon.data.DataLoader(data, batch_size=8, shuffle=True,
                                           last_batch="discard")
        losses = []
        while len(losses) < 30:
            for d, l in loader:
                losses.append(float(step(d, l).asnumpy()))
                if len(losses) == 30:
                    break
    assert all(onp.isfinite(losses))
    assert onp.mean(losses[-5:]) < onp.mean(losses[:5]), losses
