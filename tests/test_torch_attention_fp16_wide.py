"""Port parity: flash attention of ``mxnet_tpu_torch`` in float16 and at
head dims above 128 (160, padded to 192 on the card and by the Pallas
kernels to a multiple of 64, 192 and 256), against the JAX package's.

* The plain versions of the port's kernels (what the wrappers run for CPU
  tensors), forward and backward, on both entries, against the JAX
  package's Pallas kernels in interpret mode (``pallas_flash_attention``
  and its backward, ``pallas_flash_attention_bshd`` and its backward),
  with causal, kv_lens (0 among them) and segment masks and ragged T, in
  float16 (D 64 and 128) and at D 160, 192 and 256 in float32, bfloat16
  and float16.  Forward: float32 o within 2e-5 and lse within 1e-5
  (absolute; fp32 summed in another order), bfloat16 o within 2e-2 and
  float16 o within 5e-3 of the largest |o| (P is rounded to the operands'
  type before P V, against the running row max in the Pallas kernel and
  the final one here; float16's ulp is an eighth of bfloat16's), lse
  within 1e-5.  Backward, from the Pallas o and lse: float32 within 2e-5
  of the largest |gradient|, bfloat16 within 2e-2, float16 within 5e-3
  (p and ds rounded to the operands' type on both sides from fp32 values
  summed in another order); dk and dv exactly 0 past a row's valid length
  on both sides.
* The port's autograd Functions on both entries against ``jax.grad`` of
  the JAX package's public ``flash_attention``, which composes the
  attention on the CPU (its masked dense form rounds the scores to the
  operands' dtype first, the port's kernels keep them fp32): float16 at D
  64 and bfloat16 at D 192 and 256, o and the gradients within 1e-2
  (float16) and 4e-2 (bfloat16) of the largest |value|.
* The wrappers' head-dim padding (160 to 192, 256 kept, 300 refused,
  naming the roadmap) and the dtypes they take (float16 among them).
"""
import functools

import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as JA
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import attention as TA

O_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
LSE_TOL = 1e-5


def _f32(a):
    return onp.array(jnp.asarray(a, jnp.float32))


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype("float32")


def _segments(seed, B, T):
    return onp.sort(onp.random.RandomState(seed).randint(0, 3, (B, T)),
                    axis=1).astype("int32")


def _close(got, want, rel, what):
    err = onp.abs(got - want).max()
    assert err <= rel * onp.abs(want).max(), "%s: max err %.3g" % (what, err)


def _check_o(got, want, dtype, what):
    got = got.float().numpy()
    if dtype == "float32":
        onp.testing.assert_allclose(got, want, rtol=0, atol=O_TOL[dtype],
                                    err_msg=what)
    else:
        _close(got, want, O_TOL[dtype], what)


# (name, B, H, Tq, Tk, D, dtype, block, causal, kv_lens, segments); the
# block picks the TPU route (None: the whole K axis, else streamed)
BHTD_CASES = [
    ("f16_d64_lens0_causal", 2, 2, 128, 128, 64, "float16", None, True,
     (0, 100), False),
    ("f16_d128_streamed_segments", 1, 2, 256, 256, 128, "float16", 128,
     False, None, True),
] + [
    ("d%d_%s" % (D, dt), 2, 2, Tq, Tk, D, dt, block, causal, lens, seg)
    for dt in ("float32", "bfloat16", "float16")
    for D, Tq, Tk, block, causal, lens, seg in (
        (160, 200, 200, None, False, (200, 77), False),
        (192, 130, 129, None, True, None, True),
        (256, 100, 256, 128, False, (0, 190), False))
]


@functools.lru_cache(maxsize=None)
def _pallas_bhtd(case):
    name, B, H, Tq, Tk, D, dtype, block, causal, lens, seg = case
    jdt = jnp.dtype(dtype)
    q = jnp.asarray(_rand((B, H, Tq, D), len(name)), jdt)
    k = jnp.asarray(_rand((B, H, Tk, D), len(name) + 1), jdt)
    v = jnp.asarray(_rand((B, H, Tk, D), len(name) + 2, -1.0, 1.0), jdt)
    do = jnp.asarray(_rand((B, H, Tq, D), len(name) + 3, -1.0, 1.0), jdt)
    masks = dict(
        kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32),
        q_segments=jnp.asarray(_segments(1, B, Tq)) if seg else None,
        kv_segments=jnp.asarray(_segments(2, B, Tk)) if seg else None)
    o, lse = JA.pallas_flash_attention(q, k, v, causal=causal, block_q=block,
                                       block_k=block, interpret=True,
                                       return_lse=True, **masks)
    grads = JA.pallas_flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          block_q=block, block_k=block,
                                          interpret=True, **masks)
    tmasks = {k_: None if a is None else torch.from_numpy(onp.array(a))
              for k_, a in masks.items()}
    return ([_f32(a) for a in (q, k, v, do, o)], _f32(lse),
            [_f32(g) for g in grads], tmasks)


@pytest.mark.parametrize("case", BHTD_CASES, ids=[c[0] for c in BHTD_CASES])
def test_plain_matches_pallas_interpret(case):
    name, B, H, Tq, Tk, D, dtype, _, causal, lens, _ = case
    (q, k, v, do, want_o), want_lse, want, masks = _pallas_bhtd(case)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, want_o, do)]
    o, lse = TA._flash_attention_plain(t[0], t[1], t[2], causal=causal,
                                       **masks)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert tuple(o.shape) == (B, H, Tq, D)
    _check_o(o, want_o, dtype, name + " o")
    onp.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_TOL,
                                err_msg=name + " lse")
    got = TA._flash_attention_bwd_plain(
        t[0], t[1], t[2], t[3], torch.from_numpy(want_lse), t[4],
        causal=causal, **masks)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == w.shape, what
        _close(a.float().numpy(), w, BWD_TOL[dtype], "%s %s" % (name, what))
    for b, n in enumerate(lens or ()):
        assert not o[b].any() or n > 0
        for a, w in zip(got[1:], want[1:]):
            assert not a[b, :, n:].any() and not w[b, :, n:].any()


# (name, B, T, Tk, H, D, dtype, causal, kv_lens) of the (B, T, H, D) entry
BSHD_CASES = [
    ("f16_d64_lens", 2, 128, 128, 3, 64, "float16", False, (100, 128)),
    ("f16_d128_causal", 1, 128, 128, 2, 128, "float16", True, None),
    ("d160_bf16_lens0", 2, 128, 128, 2, 160, "bfloat16", False, (0, 77)),
    ("d192_f16_causal", 1, 128, 128, 2, 192, "float16", True, None),
    ("d256_f32_lens", 2, 128, 128, 2, 256, "float32", False, (128, 65)),
]


@pytest.mark.parametrize("case", BSHD_CASES, ids=[c[0] for c in BSHD_CASES])
def test_plain_bshd_matches_pallas_bshd(case):
    name, B, T, Tk, H, D, dtype, causal, lens = case
    jdt = jnp.dtype(dtype)
    q = jnp.asarray(_rand((B, T, H, D), 1), jdt)
    k, v = (jnp.asarray(_rand((B, Tk, H, D), s), jdt) for s in (2, 3))
    do = jnp.asarray(_rand((B, T, H, D), 4, -1.0, 1.0), jdt)
    kv = None if lens is None else jnp.asarray(lens, jnp.int32)
    o, lse = JA.pallas_flash_attention_bshd(
        q, k, v, causal=causal, return_lse=True, interpret=True, block_q=64,
        block_k=64, kv_lens=kv)
    want = JA.pallas_flash_attention_bwd_bshd(
        q, k, v, o, lse, do, causal=causal, interpret=True, block_q=64,
        block_k=64, kv_lens=kv)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(_f32(a)).to(tdt) for a in (q, k, v, o, do)]
    tl = None if lens is None else torch.tensor(lens)
    got_o, got_lse = TA._flash_attention_bshd_plain(t[0], t[1], t[2],
                                                    causal=causal,
                                                    kv_lens=tl)
    assert got_o.dtype == tdt and got_o.shape == (B, T, H, D)
    _check_o(got_o, _f32(o), dtype, name + " o")
    onp.testing.assert_allclose(got_lse.numpy(), _f32(lse), rtol=0,
                                atol=LSE_TOL, err_msg=name + " lse")
    got = TA._flash_attention_bshd_bwd_plain(
        t[0], t[1], t[2], t[3], torch.from_numpy(_f32(lse)), t[4],
        causal=causal, kv_lens=tl)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == w.shape, what
        _close(a.float().numpy(), _f32(w), BWD_TOL[dtype],
               "%s %s" % (name, what))
    for b, n in enumerate(lens or ()):
        for a, w in zip(got[1:], want[1:]):
            assert not a[b, n:].any() and not _f32(w)[b, n:].any()


# (T, H, D, dtype, causal, kv_lens): the autograd Functions against jax.grad
# of the JAX package's composed attention
GRAD_CASES = [
    (128, 2, 64, "float16", False, (128, 50)),
    (128, 2, 192, "bfloat16", True, None),
    (128, 2, 256, "bfloat16", False, (128, 0)),
]
GRAD_TOL = {"float16": 1e-2, "bfloat16": 4e-2}


@pytest.mark.parametrize("T,H,D,dtype,causal,lens", GRAD_CASES)
def test_functions_match_jax_grad(T, H, D, dtype, causal, lens):
    B = 2
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(_rand((B, H, T, D), s), jdt) for s in (5, 6, 7))
    do = jnp.asarray(_rand((B, H, T, D), 8, -1.0, 1.0), jdt)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)

    def fwd(a, b, c):
        return JA.flash_attention(a, b, c, causal, None, jl)
    want_o, vjp = jax.vjp(fwd, q, k, v)
    want = [want_o] + list(vjp(do))
    tdt = getattr(torch, dtype)
    tl = None if lens is None else torch.tensor(lens)
    tq, tk, tv, tdo = (torch.from_numpy(_f32(a)).to(tdt)
                       for a in (q, k, v, do))
    for entry in ("bhtd", "bshd"):
        args = [a.clone().requires_grad_() for a in (tq, tk, tv)]
        if entry == "bhtd":
            out = TA.flash_attention(*args, causal, None, tl)
        else:
            out = TA.flash_attention_bshd(
                *(a.transpose(1, 2) for a in args), causal, None,
                tl).transpose(1, 2)
        grads = torch.autograd.grad(out, args, tdo)
        assert out.dtype == tdt and all(g.dtype == tdt for g in grads)
        for what, a, w in zip(("o", "dq", "dk", "dv"), [out] + list(grads),
                              want):
            _close(a.detach().float().numpy(), _f32(w), GRAD_TOL[dtype],
                   "%s D %d %s %s" % (entry, D, dtype, what))


def test_wrappers_pad_wide_head_dims_and_refuse_past_256():
    assert TA._HEAD_DIMS == (64, 128, 192, 256)
    for D, want in ((65, 128), (129, 192), (160, 192), (192, 192),
                    (193, 256), (256, 256)):
        assert TA._padded_head_dim("x", D) == want
    with pytest.raises(mxt.MXNetError, match="ROADMAP.md, queue 2"):
        TA._padded_head_dim("x", 257)
    # the dtypes the kernels take, float16 among them; CPU tensors take the
    # plain version, whatever the dtype
    assert TA._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1,
                              torch.float16: 2}
    q = torch.zeros((1, 1, 64, 300), dtype=torch.float16)
    assert TA._kernel_operands("x", (q, q, q)) == (torch.device("cpu"), None)
    q = torch.zeros((1, 1, 64, 16), dtype=torch.float64, device="meta")
    with pytest.raises(mxt.MXNetError, match="no kernel for device"):
        TA._kernel_operands("x", (q, q, q))


def test_wrapper_runs_the_plain_version_on_cpu_at_d256_in_float16():
    q, k, v, do = (torch.from_numpy(_rand((1, 2, 130, 256), s))
                   .to(torch.float16) for s in range(4))
    before = (TA.LAUNCHES, TA.BWD_LAUNCHES)
    o, lse = TA.flash_attention_fwd(q, k, v, causal=True)
    got = TA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert (TA.LAUNCHES, TA.BWD_LAUNCHES) == before
    want_o, want_lse = TA._flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    want = TA._flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
