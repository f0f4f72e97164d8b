"""The float32 attention kernels' arithmetic, emulated on the CPU, against
the JAX package's Pallas kernels in interpret mode.

On the card the float32 forward and backward run every product on the
tensor cores as three TF32 products: each operand x is split into big =
tf32(x), rounded to nearest with ties away from zero (what
``cvt.rna.tf32.f32`` gives; the kernels compute it on the integer pipe),
and small = x - big, exact in fp32, which the tensor core reads as TF32
(its top 19 bits: small truncated); a b becomes small_a big_b + big_a
small_b + big_a big_b, summed in fp32.  A TF32 value keeps 10 stored
mantissa bits, so a product of two is exact in fp32, and float32 matmuls
of the split parts emulate the tensor cores up to the order of summation.

Here the emulation runs the forward (s = q k^T, o = p v) and the backward
(s, dp = do v^T, dv = p^T do, dq = ds k, dk = ds^T q) through those
products, with the rest in fp32 as the plain versions compute it, and is
held to ``pallas_flash_attention``/``_bwd`` and their (B, T, H, D) pair in
float32 within the card's tolerances (``chip_smoke.py``: o within 2e-5 and
lse within 1e-5 absolute, dq, dk and dv within 1e-5 of the largest
|gradient|), with causal and kv_lens masks (0 among them) and a ragged T.
The same emulation with one TF32 product (big_a big_b alone) must fail
those tolerances: one product keeps 11 significant bits, about 5e-4 of a
value.
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as JA

O_ABS, LSE_ABS, GRAD_REL = 2e-5, 1e-5, 1e-5
NEG_INF = -1e30


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, keeping 10 stored mantissa bits (on the int32
    view, the magnitude's low 13 bits rounded off; the sign bit rides
    along)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """x as the tensor core reads a float32 register as TF32: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32_truncated(x - big)


def matmul_tf32(a, b, terms=3):
    """a @ b as the tensor cores form it from TF32 products: with 3 terms
    small_a big_b + big_a small_b + big_a big_b (the small terms first),
    with 1 term big_a big_b alone."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if terms == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def visible(B, Tq, Tk, causal, lens):
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool)
    if lens is not None:
        keys = torch.arange(Tk).view(1, 1, 1, Tk)
        mask = mask & (keys < torch.tensor(lens).clamp(0, Tk).view(B, 1, 1, 1))
    if causal:
        mask = mask & (torch.arange(Tq).view(Tq, 1)
                       >= torch.arange(Tk).view(1, Tk))
    return mask


def emulated_fwd(q, k, v, causal, lens, terms):
    """(o, lse) over (B, H, T, D) float32 operands, the products as
    ``matmul_tf32`` forms them; a row that sees no key gives 0 and 0."""
    B, H, Tq, D = q.shape
    mask = visible(B, Tq, k.shape[2], causal, lens)
    s = matmul_tf32(q, k.transpose(-1, -2), terms) * D ** -0.5
    s = torch.where(mask, s, torch.tensor(NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.tensor(0.0))
    l = p.sum(-1, keepdim=True)
    o = matmul_tf32(p, v, terms) / torch.where(l > 0, l, torch.tensor(1.0))
    lse = torch.where(l > 0, m + torch.log(l), torch.tensor(0.0))
    return o, lse.squeeze(-1)


def emulated_bwd(q, k, v, o, lse, do, causal, lens, terms):
    """(dq, dk, dv) from the forward's o and lse, every product as
    ``matmul_tf32`` forms it."""
    B, H, Tq, D = q.shape
    scale = D ** -0.5
    mask = visible(B, Tq, k.shape[2], causal, lens)
    s = matmul_tf32(q, k.transpose(-1, -2), terms) * scale
    p = torch.where(mask, torch.exp(s - lse.unsqueeze(-1)),
                    torch.tensor(0.0))
    dp = matmul_tf32(do, v.transpose(-1, -2), terms)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (matmul_tf32(ds, k, terms),
            matmul_tf32(ds.transpose(-1, -2), q, terms),
            matmul_tf32(p.transpose(-1, -2), do, terms))


# (name, layout, B, H, Tq, Tk, D, causal, kv_lens, block_q, block_k)
CASES = [
    ("bhtd_causal_lens_ragged", "bhtd", 2, 2, 100, 100, 64, True, (100, 37),
     64, 32),
    ("bhtd_lens0_tq_ne_tk", "bhtd", 2, 2, 130, 129, 32, False, (0, 129), 64,
     64),
    ("bshd_causal_lens_ragged", "bshd", 2, 2, 100, 100, 64, True, (77, 100),
     64, 32),
]


def _inputs(seed, B, H, Tq, Tk, D):
    rs = onp.random.RandomState(seed)
    return (rs.uniform(-2, 2, (B, H, Tq, D)).astype("float32"),
            rs.uniform(-2, 2, (B, H, Tk, D)).astype("float32"),
            rs.uniform(-1, 1, (B, H, Tk, D)).astype("float32"),
            rs.uniform(-1, 1, (B, H, Tq, D)).astype("float32"))


_REFS = {}


def _reference(case):
    """The Pallas kernels' o, lse and gradients in interpret mode, as
    (B, H, T, D) float32 numpy arrays, with the inputs; once a case."""
    if case[0] in _REFS:
        return _REFS[case[0]]
    name, layout, B, H, Tq, Tk, D, causal, lens, bq, bk = case
    q, k, v, do = _inputs(len(name), B, H, Tq, Tk, D)
    jl = jnp.asarray(lens, jnp.int32)
    if layout == "bhtd":
        o, lse = JA.pallas_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=bq, block_k=bk, interpret=True, return_lse=True,
            kv_lens=jl)
        grads = JA.pallas_flash_attention_bwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
            jnp.asarray(do), causal=causal, block_q=bq, block_k=bk,
            interpret=True, kv_lens=jl)
        back = [onp.array(a) for a in (o,) + tuple(grads)]
    else:
        t = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, do)]
        o, lse = JA.pallas_flash_attention_bshd(
            t[0], t[1], t[2], causal=causal, block_q=bq, block_k=bk,
            interpret=True, return_lse=True, kv_lens=jl)
        grads = JA.pallas_flash_attention_bwd_bshd(
            t[0], t[1], t[2], o, lse, t[3], causal=causal, block_q=bq,
            block_k=bk, interpret=True, kv_lens=jl)
        back = [onp.array(a).transpose(0, 2, 1, 3).copy()
                for a in (o,) + tuple(grads)]
    ref = {"inputs": (q, k, v, do), "o": back[0], "lse": onp.array(lse),
           "grads": back[1:]}
    _REFS[case[0]] = ref
    return ref


def _worst(case, terms):
    """The largest ratio of an error to its tolerance over o, lse, dq, dk
    and dv, with the emulated products of ``terms`` TF32 terms, and the
    readings."""
    _, _, B, H, Tq, Tk, D, causal, lens, _, _ = case
    ref = _reference(case)
    q, k, v, do = (torch.from_numpy(a) for a in ref["inputs"])
    o, lse = emulated_fwd(q, k, v, causal, lens, terms)
    readings = {"o": onp.abs(o.numpy() - ref["o"]).max() / O_ABS,
                "lse": onp.abs(lse.numpy() - ref["lse"]).max() / LSE_ABS}
    # the backward from the reference's o and lse, as the card kernels get
    # the forward's
    got = emulated_bwd(q, k, v, torch.from_numpy(ref["o"]),
                       torch.from_numpy(ref["lse"]), do, causal, lens, terms)
    for gname, a, w in zip(("dq", "dk", "dv"), got, ref["grads"]):
        readings[gname] = (onp.abs(a.numpy() - w).max()
                           / onp.abs(w).max() / GRAD_REL)
    return max(readings.values()), readings


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                    # a TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp]
    got = tf32(x)
    assert got[:4].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # big + small keeps about 22 of x's 24 bits
    big, small = split(x)
    assert ((big + small - x).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_three_tf32_products_meet_the_card_tolerances(case):
    worst, readings = _worst(case, terms=3)
    assert worst <= 1.0, "%s: error / tolerance %s" % (case[0], readings)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_tf32_product_fails_them(case):
    worst, readings = _worst(case, terms=1)
    assert worst > 1.0, "%s: one TF32 product passed: %s" % (case[0],
                                                            readings)
