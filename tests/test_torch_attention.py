"""Port parity: flash attention of ``mxnet_tpu_torch`` against the JAX
package's.

The plain version of the port's kernel (``_flash_attention_plain``, what
the wrapper runs for CPU tensors) against the JAX package's Pallas forward
run in interpret mode, o and lse, with the whole K axis as one block (the
single-pass TPU kernel) and with K streamed in 128-key blocks over Tk = 256
(the online-softmax TPU kernel).  Tolerances: float32 o within 2e-5 and lse
within 1e-5 (absolute; the same fp32 arithmetic in another summation
order); bfloat16 o within 2e-2 of the largest |o| (P is rounded to bf16
before P·V, relative to the running max in the streaming kernel and to the
row max here), lse within 1e-5 (fp32 scores from bf16 inputs).  The public
op against the JAX package's on the CPU, where the JAX package composes
the attention: float32 within 2e-5, and bfloat16 without masks within
one bf16 ulp of the largest |o|.  And the
per-shape dispatcher's labels against the JAX package's.
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as JA
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.ops.registry import get_op

F32_O, F32_LSE, BF16_REL = 2e-5, 1e-5, 2e-2


def _inputs(seed, B, H, Tq, Tk, D):
    rs = onp.random.RandomState(seed)
    q = rs.uniform(-2, 2, (B, H, Tq, D)).astype("float32")
    k = rs.uniform(-2, 2, (B, H, Tk, D)).astype("float32")
    v = rs.uniform(-1, 1, (B, H, Tk, D)).astype("float32")
    return q, k, v


def _segments(seed, B, T):
    return onp.sort(onp.random.RandomState(seed).randint(0, 3, (B, T)),
                    axis=1).astype("int32")


def _check(got, want, dtype, what):
    got = got.float().numpy()
    want = onp.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        onp.testing.assert_allclose(got, want, rtol=0, atol=F32_O,
                                    err_msg=what)
    else:
        err = onp.abs(got - want).max() / onp.abs(want).max()
        assert err <= BF16_REL, "%s: rel err %.3g" % (what, err)


# (name, B, H, Tq, Tk, D, dtype, block, causal, kv_lens, segments)
CASES = [
    ("single_ragged_segments_f32", 1, 2, 200, 200, 32, "float32", None,
     False, None, True),
    ("single_lens_0_and_past_tk_q_ne_k", 2, 2, 72, 200, 32, "float32", None,
     False, (0, 300), False),
    ("single_causal_lens_bf16", 2, 2, 128, 128, 64, "bfloat16", None, True,
     (5, 100), False),
    ("streaming_lens_causal_f32", 2, 2, 200, 256, 32, "float32", 128, True,
     (130, 400), False),
    ("streaming_segments_bf16", 1, 2, 256, 256, 64, "bfloat16", 128, False,
     None, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case):
    name, B, H, Tq, Tk, D, dtype, block, causal, lens, seg = case
    q, k, v = _inputs(len(name), B, H, Tq, Tk, D)
    qs = ks = None
    if seg:
        qs, ks = _segments(1, B, Tq), _segments(1, B, Tk)
    jdt = jnp.dtype(dtype)
    want_o, want_lse = JA.pallas_flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=causal, block_q=block, block_k=block, interpret=True,
        return_lse=True,
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
        q_segments=None if qs is None else jnp.asarray(qs),
        kv_segments=None if ks is None else jnp.asarray(ks))
    tdt = getattr(torch, dtype)
    got_o, got_lse = TA._flash_attention_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=causal,
        kv_lens=None if lens is None else torch.tensor(lens),
        q_segments=None if qs is None else torch.from_numpy(qs),
        kv_segments=None if ks is None else torch.from_numpy(ks))
    assert got_o.dtype == tdt and got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == (B, H, Tq)
    _check(got_o, want_o, dtype, name + " o")
    onp.testing.assert_allclose(got_lse.numpy(), onp.asarray(want_lse),
                                rtol=0, atol=F32_LSE, err_msg=name + " lse")
    if lens is not None and lens[0] == 0:
        # a row that sees no key: o = 0 and lse = 0 exactly
        assert not got_o[0].any() and not got_lse[0].any()


def test_wrapper_runs_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 130, 130, 16))
    before = TA.LAUNCHES
    o, lse = TA.flash_attention_fwd(q, k, v, causal=True)
    want_o, want_lse = TA._flash_attention_plain(q, k, v, causal=True)
    assert TA.LAUNCHES == before          # no kernel on the CPU
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("T,causal,lens", [
    (160, True, (160, 0)),      # the kernel's route here
    (64, False, (64, 9)),       # composed on both sides
])
def test_public_op_matches_jax(T, causal, lens):
    """The registered op against the JAX package's public op, which
    composes the attention on the CPU."""
    dtype = "float32"
    assert get_op("flash_attention") is get_op("_contrib_flash_attention")
    q, k, v = _inputs(T, 2, 2, T, T, 32)
    jdt = jnp.dtype(dtype)
    want = JA.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal, None, jnp.asarray(lens, jnp.int32))
    with mxt.cpu():
        got = mxt.nd._contrib_flash_attention(
            mxt.nd.array(q, dtype=dtype), mxt.nd.array(k, dtype=dtype),
            mxt.nd.array(v, dtype=dtype), causal=causal,
            kv_lens=mxt.nd.array(onp.array(lens, "int32"), dtype="int32"))
    _check(got.astorch(), want, dtype, "public op")


@pytest.mark.parametrize("causal", [False, True])
def test_unmasked_bf16_composed_attention_matches_jax(causal):
    """Without kv_lens and segments the JAX package composes short
    attention blockwise: fp32 scores, the unnormalised probabilities
    rounded to bf16 for p·v, one division at the end.  Within one bf16
    ulp of the largest |o|."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(11, 2, 2, 64, 64, 64))
    want = JA.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal)
    got = TA.flash_attention(q, k, v, causal)
    assert got.dtype == torch.bfloat16
    want = onp.asarray(jnp.asarray(want, jnp.float32))
    ulp = 2.0 ** (onp.floor(onp.log2(onp.abs(want).max())) - 7)
    assert onp.abs(got.float().numpy() - want).max() <= ulp


# (Tq, Tk, D): shapes where both packages give the same label
DISPATCH_SHAPES = [(64, 64, 64), (127, 512, 64), (512, 100, 64),
                   (128, 128, 64), (384, 384, 64), (512, 512, 64),
                   (200, 1000, 32), (1024, 1024, 64), (512, 4096, 64),
                   (4096, 4096, 128)]


def test_dispatch_labels_match_jax():
    for tq, tk, d in DISPATCH_SHAPES:
        want = JA.attention_dispatch(tq, tk, d, "bfloat16", on_tpu=True,
                                     census=False)
        got = TA.attention_dispatch(tq, tk, d, "bfloat16", census=False)
        assert got["kernel"] == want["kernel"], (tq, tk, d)
        if got["kernel"] == "dense_fallback":
            assert got["block_q"] is None and got["tuner_source"] is None
        else:
            assert (got["block_q"], got["block_k"]) == (TA.BLOCK_Q,
                                                        TA.BLOCK_K)
            assert got["tuner_source"] == "heuristic"
    # past 1024 keys the port always streams (one CUDA kernel either way)
    assert TA.attention_dispatch(2048, 2048, 64,
                                 census=False)["kernel"] == "streaming"


def test_dispatch_counts_each_call():
    before = telemetry.counter("attention.kernel.short_seq")
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 1, 128, 128, 8))
    for _ in range(3):
        TA.flash_attention(q, k, v)
    assert telemetry.counter("attention.kernel.short_seq") == before + 3
