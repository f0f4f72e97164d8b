"""Port parity: the flash-attention backward of ``mxnet_tpu_torch`` against
the JAX package's.

The plain version of the port's backward kernels
(``_flash_attention_bwd_plain``, what the wrapper runs for CPU tensors)
against the JAX package's Pallas backward in interpret mode, on the same
q, k, v, o, lse and cotangent (o and lse from the Pallas forward), on the
three TPU backward routes: ``_dqkv_single_kernel`` (one Q and one K block),
``_dqkv_fused_kernel`` (one K block, Q streamed) and ``_dq_kernel`` +
``_dkv_kernel`` (K in several blocks), with causal, kv_lens (0 among them)
and segment masks, in float32 and bfloat16.  float32 within 2e-5 of the
largest |gradient| (the same fp32 arithmetic summed in another order);
bfloat16 within 2e-2 of it (p and ds are rounded to bf16 before their
products on both sides, from fp32 values summed in another order, so a
rounding can fall either way: one bf16 ulp is 2**-8 of a value).  Rows of
dk and dv past a row's valid length are exactly 0 on both sides.

The port's autograd Function (``flash_attention`` with a recorded
gradient) against ``jax.grad`` of the JAX package's ``flash_attention``,
which differentiates the composed attention on the CPU: float32, within
2e-5 of the largest |gradient|.
"""
import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as JA
from mxnet_tpu_torch.ops import attention as TA

F32_REL, BF16_REL = 2e-5, 2e-2


def _inputs(seed, B, H, Tq, Tk, D):
    rs = onp.random.RandomState(seed)
    q = rs.uniform(-2, 2, (B, H, Tq, D)).astype("float32")
    k = rs.uniform(-2, 2, (B, H, Tk, D)).astype("float32")
    v = rs.uniform(-1, 1, (B, H, Tk, D)).astype("float32")
    do = rs.uniform(-1, 1, (B, H, Tq, D)).astype("float32")
    return q, k, v, do


def _segments(seed, B, T):
    return onp.sort(onp.random.RandomState(seed).randint(0, 3, (B, T)),
                    axis=1).astype("int32")


def _f32(a):
    return onp.array(jnp.asarray(a, jnp.float32))


def _close(got, want, rel, what):
    err = onp.abs(got - want).max()
    assert err <= rel * onp.abs(want).max(), "%s: max err %.3g" % (what, err)


# (name, B, H, Tq, Tk, D, dtype, block_q, block_k, causal, kv_lens,
# segments): the blocks pick the TPU route
CASES = [
    ("single_causal_lens0_f32", 2, 2, 128, 128, 32, "float32", 128, 128,
     True, (0, 90), False),
    ("single_segments_bf16", 1, 2, 128, 128, 32, "bfloat16", 128, 128,
     False, None, True),
    ("fused_lens_bf16", 2, 1, 256, 128, 32, "bfloat16", 128, 128, False,
     (128, 77), False),
    ("fused_segments_causal_f32", 1, 2, 256, 128, 32, "float32", 128, 128,
     True, None, True),
    ("split_lens_causal_f32", 2, 1, 256, 256, 32, "float32", 128, 128,
     True, (256, 150), False),
    ("split_segments_bf16", 1, 1, 256, 256, 64, "bfloat16", 128, 128,
     False, None, True),
    # the edges of the card kernels' tile ring: a ragged last K tile with
    # kv_lens on a tile edge and 0, and causal with Tq != Tk
    ("split_tk65_lens64_bf16", 2, 1, 96, 65, 32, "bfloat16", 64, 32, False,
     (64, 0), False),
    ("fused_tk129_lens128_f32", 1, 2, 64, 129, 32, "float32", 64, 256,
     False, (128,), False),
    ("split_causal_tq_lt_tk_f32", 1, 2, 64, 129, 32, "float32", 32, 64,
     True, None, False),
    ("split_causal_tq_gt_tk_lens_bf16", 2, 1, 129, 65, 32, "bfloat16", 64,
     32, True, (65, 64), False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case):
    (name, B, H, Tq, Tk, D, dtype, bq, bk, causal, lens, seg) = case
    q, k, v, do = _inputs(len(name), B, H, Tq, Tk, D)
    qs = ks = None
    if seg:
        qs, ks = _segments(1, B, Tq), _segments(2, B, Tk)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    masks = dict(
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
        q_segments=None if qs is None else jnp.asarray(qs),
        kv_segments=None if ks is None else jnp.asarray(ks))
    o, lse = JA.pallas_flash_attention(jq, jk, jv, causal=causal,
                                       block_q=bq, block_k=bk,
                                       interpret=True, return_lse=True,
                                       **masks)
    want = JA.pallas_flash_attention_bwd(jq, jk, jv, o, lse, jdo,
                                         causal=causal, block_q=bq,
                                         block_k=bk, interpret=True, **masks)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(_f32(a)).to(tdt) for a in (jq, jk, jv, o, jdo)]
    got = TA._flash_attention_bwd_plain(
        t[0], t[1], t[2], t[3], torch.from_numpy(_f32(lse)), t[4],
        causal=causal,
        kv_lens=None if lens is None else torch.tensor(lens),
        q_segments=None if qs is None else torch.from_numpy(qs),
        kv_segments=None if ks is None else torch.from_numpy(ks))
    rel = F32_REL if dtype == "float32" else BF16_REL
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == w.shape, what
        _close(a.float().numpy(), _f32(w), rel, "%s %s" % (name, what))
    if lens is not None:
        for a, w in zip(got[1:], want[1:]):
            for b, n in enumerate(lens):
                assert not a[b, :, n:].any()
                assert not _f32(w)[b, :, n:].any()


def test_wrapper_runs_the_plain_version_on_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 130, 130,
                                                        16))
    o, lse = TA.flash_attention_fwd(q, k, v, causal=True)
    before = TA.BWD_LAUNCHES
    got = TA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = TA._flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert TA.BWD_LAUNCHES == before          # no kernel on the CPU
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_wrapper_raises_for_a_device_without_a_kernel():
    q = torch.zeros((1, 1, 128, 16), device="meta")
    lse = torch.zeros((1, 1, 128), device="meta")
    with pytest.raises(TA.MXNetError, match="no kernel for device"):
        TA.flash_attention_bwd(q, q, q, q, lse, q)


@pytest.mark.parametrize("T,causal,lens,seg", [
    (160, False, (160, 0), False),      # the kernels' route
    (128, True, None, True),            # the kernels' route, segments
    (64, False, (64, 9), False),        # composed on both sides
])
def test_function_grads_match_jax_grad(T, causal, lens, seg):
    q, k, v, do = _inputs(T, 2, 2, T, T, 32)
    qs = _segments(4, 2, T) if seg else None
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    js = None if qs is None else jnp.asarray(qs)

    def loss(a, b, c):
        out = JA.flash_attention(a, b, c, causal, None, jl, js, js)
        return jnp.sum(out * jnp.asarray(do))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ts = None if qs is None else torch.from_numpy(qs)
    out = TA.flash_attention(
        tq, tk, tv, causal, None,
        None if lens is None else torch.tensor(lens), ts, ts)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), _f32(w), F32_REL, "T %d %s" % (T, what))
