"""Port parity: the (B, T, H, D) flash-attention entries of
``mxnet_tpu_torch`` against the JAX package's.

* The plain versions of the port's BSHD kernels
  (``_flash_attention_bshd_plain`` and ``_flash_attention_bshd_bwd_plain``,
  what the wrappers run for CPU tensors) against the JAX package's
  ``pallas_flash_attention_bshd`` and ``pallas_flash_attention_bwd_bshd``
  in interpret mode with 64 x 64 blocks, at (B, T, H, D) = (2, 128, 3, 64),
  plain and causal, kv_lens None and (100, 128), float32 and bfloat16.
  Forward: float32 o within 2e-5 and lse within 1e-5 (absolute), bfloat16
  o within 2e-2 of the largest |o|, the tolerances of
  tests/test_torch_attention.py.  Backward (from the Pallas o and lse):
  float32 within 2e-5 and bfloat16 within 2e-2 of the largest |gradient|,
  those of tests/test_torch_attention_bwd.py; rows of dk and dv past a
  valid length exactly 0 on both sides.
* The wrappers on strided views (the column blocks of one (B, T, 3 H D)
  buffer), the backward writing into views of one gradient: the plain
  versions' bits, no launch counted.
* The public op ``flash_attention_bshd`` under ``autograd.record`` against
  ``jax.grad`` of the JAX package's, which composes the attention on the
  CPU: float32 within 2e-5 of the largest |value|, at T 128 (the kernels'
  route) and T 64 (the composed route on both sides).
* ``MultiHeadAttention`` goes through the BSHD entries (a spy) and matches
  the JAX layer within 1e-5; ``load_jax_params`` still maps every BERT
  parameter.
"""
import functools

import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.contrib.nn import transformer as jtr
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import pallas_attention as JA
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.contrib.nn import transformer as ttr
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.ops.registry import get_op

F32_O, F32_LSE, F32_REL, BF16_REL = 2e-5, 1e-5, 2e-5, 2e-2
B, T, H, D = 2, 128, 3, 64

CASES = [(causal, lens, dtype) for dtype in ("float32", "bfloat16")
         for causal in (False, True) for lens in (None, (100, 128))]
IDS = ["%s-%s-%s" % (dt, "causal" if c else "plain",
                     "lens" if lens else "nolens") for c, lens, dt in CASES]


def _f32(a):
    return onp.array(jnp.asarray(a, jnp.float32))


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype("float32")


@functools.lru_cache(maxsize=None)
def _pallas(causal, lens, dtype):
    """Inputs (rounded to dtype, as float32 numpy) and the Pallas BSHD
    forward and backward of one case."""
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(_rand((B, T, H, D), i), jdt) for i in range(3))
    do = jnp.asarray(_rand((B, T, H, D), 7, -1.0, 1.0), jdt)
    kv = None if lens is None else jnp.asarray(lens, jnp.int32)
    o, lse = JA.pallas_flash_attention_bshd(
        q, k, v, causal=causal, return_lse=True, interpret=True, block_q=64,
        block_k=64, kv_lens=kv)
    grads = JA.pallas_flash_attention_bwd_bshd(
        q, k, v, o, lse, do, causal=causal, interpret=True, block_q=64,
        block_k=64, kv_lens=kv)
    return ([_f32(a) for a in (q, k, v, do, o)], _f32(lse),
            [_f32(g) for g in grads])


def _close(got, want, rel, what):
    err = onp.abs(got - want).max()
    assert err <= rel * onp.abs(want).max(), "%s: max err %.3g" % (what, err)


@pytest.mark.parametrize("causal,lens,dtype", CASES, ids=IDS)
def test_plain_forward_matches_pallas_bshd(causal, lens, dtype):
    (q, k, v, _, want_o), want_lse, _ = _pallas(causal, lens, dtype)
    tdt = getattr(torch, dtype)
    o, lse = TA._flash_attention_bshd_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        kv_lens=None if lens is None else torch.tensor(lens))
    assert o.dtype == tdt and o.shape == (B, T, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    if dtype == "float32":
        onp.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=F32_O)
    else:
        _close(o.float().numpy(), want_o, BF16_REL, "o")
    onp.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=F32_LSE)


@pytest.mark.parametrize("causal,lens,dtype", CASES, ids=IDS)
def test_plain_backward_matches_pallas_bshd(causal, lens, dtype):
    (q, k, v, do, o), lse, want = _pallas(causal, lens, dtype)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, o, do)]
    got = TA._flash_attention_bshd_bwd_plain(
        t[0], t[1], t[2], t[3], torch.from_numpy(lse), t[4], causal=causal,
        kv_lens=None if lens is None else torch.tensor(lens))
    rel = F32_REL if dtype == "float32" else BF16_REL
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == w.shape, what
        _close(a.float().numpy(), w, rel, what)
    for b, n in enumerate(lens or ()):
        for a, w in zip(got[1:], want[1:]):
            assert not a[b, n:].any() and not w[b, n:].any()


def _packed(seed, dtype=torch.float32):
    """q, k and v as the column blocks of one (B, T, 3 H D) buffer."""
    buf = torch.from_numpy(_rand((B, T, 3 * H * D), seed)).to(dtype)
    return buf, TA._qkv_heads(buf, H)


def test_wrappers_take_strided_views_on_cpu():
    buf, (q, k, v) = _packed(5)
    assert not q.is_contiguous() and q.stride() == (T * 3 * H * D,
                                                    3 * H * D, D, 1)
    lens = torch.tensor([100, 128])
    before = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES)
    o, lse = TA.flash_attention_bshd_fwd(q, k, v, True, None, lens)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    want_o, want_lse = TA._flash_attention_bshd_plain(qc, kc, vc, True,
                                                      None, lens)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    do = torch.from_numpy(_rand((B, T, H, D), 9))
    grad = torch.full_like(buf, float("nan"))
    out = TA._qkv_heads(grad, H)
    got = TA.flash_attention_bshd_bwd(q, k, v, o, lse, do, True, None, lens,
                                      out=out)
    want = TA._flash_attention_bshd_bwd_plain(qc, kc, vc, o, lse, do, True,
                                              None, lens)
    assert all(g is w for g, w in zip(got, out))
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert not torch.isnan(grad).any()          # every column written
    assert (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES) == before


def test_wrappers_check_shapes():
    q = torch.zeros((1, 128, 2, 16))
    with pytest.raises(ValueError, match="flash_attention_bshd_fwd"):
        TA.flash_attention_bshd_fwd(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="lse"):
        TA.flash_attention_bshd_bwd(q, q, q, q, torch.zeros((1, 128, 2)), q)


@pytest.mark.parametrize("seq,lens", [(128, (128, 70)), (64, (64, 9))],
                         ids=["kernel_route", "composed_route"])
def test_public_op_grads_match_jax_grad(seq, lens):
    assert get_op("flash_attention_bshd") is \
        get_op("_contrib_flash_attention_bshd")
    q, k, v = (_rand((B, seq, H, 32), 20 + i) for i in range(3))
    do = _rand((B, seq, H, 32), 30, -1.0, 1.0)
    jl = jnp.asarray(lens, jnp.int32)

    def loss(a, b, c):
        out = JA.flash_attention_bshd(a, b, c, True, None, jl)
        return jnp.sum(out * jnp.asarray(do)), out
    (_, want_o), want = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    with mxt.cpu():
        args = [mxt.nd.array(a) for a in (q, k, v)]
        for a in args:
            a.attach_grad()
        with mxt.autograd.record():
            out = mxt.nd.flash_attention_bshd(
                *args, causal=True,
                kv_lens=mxt.nd.array(onp.array(lens, "int32")))
        out.backward(mxt.nd.array(do))
    _close(out.asnumpy(), _f32(want_o), F32_REL, "o")
    for what, a, w in zip(("dq", "dk", "dv"), args, want):
        _close(a.grad.asnumpy(), _f32(w), F32_REL, what)


def test_multi_head_attention_takes_the_bshd_entries(monkeypatch):
    """At T >= 128 the layer runs the BSHD pair on its fused projection
    output (never the (B, H, T, D) entries), and agrees with the JAX
    layer: output and the input's gradient within 1e-5."""
    units, heads, seq = 128, 2, 128
    x = _rand((B, seq, units), 40, -1.0, 1.0)
    lens = onp.array([seq, 77], "int32")
    mx.random.seed(4)
    # an explicit prefix leaves the JAX package's global block counters
    # as they were, for the tests that run after this one
    jnet = jtr.MultiHeadAttention(units, heads, prefix="bshd_mha_")
    jnet.initialize(mx.init.Xavier())
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jout = jnet(jx, None, mx.nd.array(lens, dtype="int32"))
    jout.backward(mx.nd.ones(jout.shape))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}

    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    def refuse(*a, **kw):
        raise AssertionError("a (B, H, T, D) entry was called")
    for name in ("flash_attention_bshd_fwd", "flash_attention_bshd_bwd"):
        monkeypatch.setattr(TA, name, spy(getattr(TA, name)))
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        monkeypatch.setattr(TA, name, refuse)
    net = ttr.MultiHeadAttention(units, heads)
    with mxt.cpu():
        net.initialize()
        net(mxt.nd.zeros((1, seq, units)))
        load_jax_params(net, arrays)
        tx = mxt.nd.array(x)
        tx.attach_grad()
        with mxt.autograd.record():
            tout = net(tx, None, mxt.nd.array(lens))
        tout.backward(mxt.nd.ones(tout.shape))
    assert calls == ["flash_attention_bshd_fwd", "flash_attention_bshd_fwd",
                     "flash_attention_bshd_bwd"]
    onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                                atol=1e-5)
    onp.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                                rtol=0, atol=1e-5)


def test_load_jax_params_maps_every_bert_parameter():
    """The layer change renames nothing: every parameter of the JAX
    package's BERT lands in the port's, with its values."""
    small = dict(num_layers=2, units=64, hidden_size=128, vocab_size=50,
                 max_length=16, dropout=0.0, use_pooler=True,
                 use_decoder=True)
    jnet = jbert.bert_small(prefix="bshd_bert_", **small)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 8)))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = tbert.bert_small(**small)
    with mxt.cpu():
        net.initialize()
        net(mxt.nd.zeros((1, 8)))
        load_jax_params(net, arrays)
    got = {k: p.data().asnumpy()
           for k, p in net._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(arrays)
    assert any(".attention.qkv." in k for k in got)
    for k, a in arrays.items():
        onp.testing.assert_array_equal(got[k], a)
