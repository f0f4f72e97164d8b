"""Port parity: BERT of ``mxnet_tpu_torch`` against the JAX package's, on
weights carried over from the JAX net with ``load_jax_params``.

``bert_small`` with 2 layers, 64 units and 4 heads (D = 16), pooler and
masked-LM decoder, float32, batch 2 x 128, per-row valid lengths and 3
masked positions a row.  The port takes its kernels' routes (their plain
versions on the CPU) with ``MXNET_FUSED_LAYERNORM=1``; the JAX package
composes attention and LayerNorm on the CPU.
Sequence output, pooled output and logits agree within 1e-5 (float32 on
both sides, summed in another order).  Also: the additive-mask path of
``MultiHeadAttention``, the slice's other ops against the JAX package's
(1e-6: the same float32 arithmetic), ``Dropout`` outside and inside
training, and the structural names and shapes of ``bert_base``.
"""
import numpy as onp

import mxnet_tpu as mx
from mxnet_tpu.gluon.contrib.nn import transformer as jtr
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.contrib.nn import transformer as ttr
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.utils import load_jax_params

TOL = 1e-5
SMALL = dict(num_layers=2, units=64, hidden_size=128, vocab_size=97,
             max_length=128, dropout=0.0, use_pooler=True, use_decoder=True)


def _arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _bert_inputs(seq_len, seed):
    rs = onp.random.RandomState(seed)
    tokens = rs.randint(0, SMALL["vocab_size"], (2, seq_len)).astype("float32")
    types = rs.randint(0, 2, (2, seq_len)).astype("float32")
    lens = onp.array([seq_len, seq_len // 2 + 1], "int32")
    pos = onp.sort(onp.stack([rs.choice(seq_len // 2, 3, replace=False)
                              for _ in range(2)]), 1).astype("int32")
    return tokens, types, lens, pos


def test_bert_small_matches_jax(monkeypatch):
    seq_len = 128
    tokens, types, lens, pos = _bert_inputs(seq_len, 0)
    mx.random.seed(3)
    jnet = jbert.bert_small(**SMALL)
    jnet.initialize(mx.init.Xavier())
    want = [o.asnumpy() for o in jnet(
        mx.nd.array(tokens), mx.nd.array(types), None,
        mx.nd.array(lens, dtype="int32"), mx.nd.array(pos, dtype="int32"))]
    arrays = _arrays(jnet)
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    net = tbert.bert_small(**SMALL)
    with mxt.cpu():
        net.initialize()
        load_jax_params(net, arrays)
        got = [o.asnumpy() for o in net(
            mxt.nd.array(tokens), mxt.nd.array(types), None,
            mxt.nd.array(lens, dtype="int32"),
            mxt.nd.array(pos, dtype="int32"))]
    assert [g.shape for g in got] == [(2, seq_len, 64), (2, 64), (2, 3, 97)]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_multi_head_attention_additive_mask_path_matches_jax():
    rs = onp.random.RandomState(5)
    x = rs.uniform(-1, 1, (2, 8, 32)).astype("float32")
    mask = onp.where(rs.uniform(size=(2, 1, 8, 8)) < 0.2, -1e4,
                     0.0).astype("float32")
    lens = onp.array([8, 5], "int32")
    jmha = jtr.MultiHeadAttention(32, 4)
    jmha.initialize(mx.init.Xavier())
    want = jmha(mx.nd.array(x), mx.nd.array(mask),
                mx.nd.array(lens, dtype="int32")).asnumpy()
    mha = ttr.MultiHeadAttention(32, 4)
    with mxt.cpu():
        mha.initialize()
        load_jax_params(mha, _arrays(jmha))
        got = mha(mxt.nd.array(x), mxt.nd.array(mask),
                  mxt.nd.array(lens, dtype="int32")).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ops_of_the_slice_match_jax():
    rs = onp.random.RandomState(7)
    x = rs.uniform(-3, 3, (2, 5, 6)).astype("float32")
    y = rs.uniform(-3, 3, (2, 6, 4)).astype("float32")
    ids = onp.array([[0.0, 3.9, 99.0], [-2.0, 1.0, 5.0]], "float32")
    pos = onp.array([[4, 0], [9, -1]], "int32")
    length = onp.array([[3, 6, 1, 2, 6], [6, 2, 4, 5, 1]], "int32")
    cases = [("LeakyReLU", (x,), dict(act_type=a))
             for a in ("leaky", "elu", "selu", "gelu", "rrelu")]
    cases += [("softmax", (x,), dict(axis=-1)),
              ("softmax", (x, length), dict(axis=-1, use_length=True)),
              ("Embedding", (ids, y[0]), dict(input_dim=6, output_dim=4)),
              ("gather_positions", (x, pos), {}),
              ("batch_dot", (x, y), {}),
              ("batch_dot", (x, x), dict(transpose_b=True)),
              ("slice_axis", (x,), dict(axis=1, begin=1, end=3)),
              ("transpose", (x,), dict(axes=(2, 0, 1))),
              ("broadcast_greater_equal", (x, y[:1, :1, :1]), {}),
              ("Cast", (x,), dict(dtype="int32"))]
    for name, args, kw in cases:
        jargs = [mx.nd.array(a, dtype=a.dtype) for a in args]
        want = getattr(mx.nd, name)(*jargs, **kw).asnumpy()
        with mxt.cpu():
            targs = [mxt.nd.array(a, dtype=a.dtype) for a in args]
            got = getattr(mxt.nd, name)(*targs, **kw).asnumpy()
        assert got.dtype == want.dtype, name
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                    err_msg="%s %s" % (name, kw))
    with mxt.cpu():
        parts = mxt.nd.split(mxt.nd.array(x), num_outputs=3, axis=-1)
        onp.testing.assert_array_equal(
            mxt.nd.arange(2, 11, 3).asnumpy(),
            mx.nd.arange(2, 11, 3).asnumpy())
    want = mx.nd.split(mx.nd.array(x), num_outputs=3, axis=-1)
    for g, w in zip(parts, want):
        onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_dropout_is_identity_outside_training_and_masks_in_it():
    x = onp.random.RandomState(6).uniform(1, 2, (64, 32)).astype("float32")
    drop = mxt.gluon.nn.Dropout(0.25)
    with mxt.cpu():
        xa = mxt.nd.array(x)
        onp.testing.assert_array_equal(drop(xa).asnumpy(), x)
        outs = []
        for _ in range(2):
            mxt.random.seed(11)
            with mxt.autograd.train_mode():
                outs.append(drop(xa).asnumpy())
    y = outs[0]
    kept = y != 0
    onp.testing.assert_allclose(y[kept], x[kept] / 0.75, rtol=1e-6)
    assert 0.65 < kept.mean() < 0.85
    onp.testing.assert_array_equal(outs[0], outs[1])   # seeded


def test_bert_base_structural_names_and_shapes_match_jax():
    jnet = jbert.bert_base(use_pooler=False, use_decoder=True)
    net = tbert.bert_base(use_pooler=False, use_decoder=True)
    want = {k: p.shape for k, p in jnet._collect_params_with_prefix().items()}
    got = {k: p.shape for k, p in net._collect_params_with_prefix().items()}
    assert got == want
    assert "encoder.11.ffn.contract.weight" in got
    assert got["word_embed.weight"] == (30522, 768)
