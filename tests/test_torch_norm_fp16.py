"""Port parity in float16: the BN -> add -> ReLU epilogue and LayerNorm of
``mxnet_tpu_torch`` against the JAX package's Pallas kernels (interpret
mode, as tests/test_fused_bn_epilogue.py and tests/test_pallas_layernorm.py
run them on the CPU) and its jnp paths, from numpy inputs made from a seed.

On the CPU the port's wrappers run the kernels' plain versions: fp32
arithmetic in the kernels' order of operations, one rounding to float16
at each store, as the Hopper kernels round (``__float2half_rn``).

Tolerances:
* epilogue forward, dx and dr: within 1 float16 ulp (bits read as
  integers); both sides round the same fp32 value once, so only a
  contracted multiply-add can move the last bit; dscale and dshift (fp32)
  within 1e-5 of their largest entry (the channel sums in another order);
* LayerNorm y and dx: within 1e-5 plus one ulp of their dtype at the
  larger value (fp32 values that agree within 1e-5, the row statistics
  summed in another order, each rounded once: near 0 an ulp is far below
  1e-5, so an ulp count alone would not do); mu and rstd within 1e-5
  relative; dgamma and dbeta within 1e-5 of their largest entry;
* against the JAX package's jnp LayerNorm (what its fused op runs on the
  CPU: the normalised values rounded to the data dtype before the affine,
  a second rounding the kernel does not make): within 1e-2 of the largest
  |value|, a float16 ulp or two of a value (2**-11 of it each).
Values past 65504 become inf on both sides, as ``astype`` gives.
"""
import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_fused_norm as FN
from mxnet_tpu.ops import pallas_layernorm as JL
from mxnet_tpu_torch.ops import fused_norm as TFN
from mxnet_tpu_torch.ops import layernorm as TL
from mxnet_tpu_torch.ops import nn as tnn

SUM_REL, F32_ATOL, JNP_REL = 1e-5, 1e-5, 1e-2
# mantissa bits a dtype keeps after the leading one
MANT = {"float32": 23, "bfloat16": 7, "float16": 10}
DTYPES = ("float32", "bfloat16", "float16")


def _rand(shape, seed, scale=1.0):
    return (onp.random.RandomState(seed).uniform(-1, 1, shape) * scale) \
        .astype("float32")


def _f32(a):
    return onp.array(jnp.asarray(a, jnp.float32))


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _half_bits(a):
    """float16 values as integers (sign and magnitude), -0 read as +0."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    bits = onp.asarray(a, onp.float16).view(onp.uint16).astype(onp.int64)
    mag = bits & 0x7FFF
    return onp.where(bits & 0x8000, -mag, mag)


def _within_ulps(got, want, ulps=1):
    return onp.abs(_half_bits(got) - _half_bits(want)).max() <= ulps


def _ulp_tol(got, want, dtype):
    """1e-5 plus one ulp of ``dtype`` at the larger of |got| and |want|."""
    _, e = onp.frexp(onp.maximum(onp.abs(got), onp.abs(want)))
    return F32_ATOL + onp.ldexp(1.0, e - 1 - MANT[dtype])


# ------------------------------------------------------------ the epilogue

@pytest.mark.parametrize("rows,cols", [(70, 200), (3, 37)])
def test_epilogue_fwd_matches_pallas_interpret_and_jnp(rows, cols):
    x, r = _rand((rows, cols), 0, 4), _rand((rows, cols), 1, 4)
    s, t = _rand((cols,), 2) + 1.0, _rand((cols,), 3)
    xj, rj = jnp.asarray(x, jnp.float16), jnp.asarray(r, jnp.float16)
    port = TFN.fused_scale_shift_add_relu(
        torch.from_numpy(x).half(), torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(r).half())
    assert port.dtype == torch.float16
    kernel = FN.pallas_epilogue_fwd(xj, jnp.asarray(s[None]),
                                    jnp.asarray(t[None]), rj, interpret=True)
    ref = FN._jnp_epilogue(xj, jnp.asarray(s[None]), jnp.asarray(t[None]), rj)
    assert kernel.dtype == ref.dtype == jnp.float16
    assert _within_ulps(port, kernel) and _within_ulps(port, ref)


@pytest.mark.parametrize("rows,cols", [(70, 200), (3, 37)])
def test_epilogue_bwd_matches_pallas_interpret(rows, cols):
    x, r = _rand((rows, cols), 4, 4), _rand((rows, cols), 5, 4)
    ct = _rand((rows, cols), 6, 2)
    s, t = _rand((cols,), 7) + 1.0, _rand((cols,), 8)
    tx, tr, tct = (torch.from_numpy(a).half() for a in (x, r, ct))
    ts = torch.from_numpy(s)
    y = TFN.fused_bn_add_relu_epilogue_plain(tx, ts, torch.from_numpy(t), tr,
                                             1)
    dx, dr, ds, dt = TFN.fused_bn_add_relu_epilogue_bwd(tx, ts, y, tct, 1)
    assert [_dt(v) for v in (dx, dr, ds, dt)] == ["float16"] * 2 + \
        ["float32"] * 2
    w = FN.pallas_epilogue_bwd(jnp.asarray(x, jnp.float16),
                               jnp.asarray(s[None]),
                               jnp.asarray(y.numpy()),
                               jnp.asarray(ct, jnp.float16), interpret=True)
    assert w[0].dtype == w[1].dtype == jnp.float16
    assert _within_ulps(dx, w[0]) and _within_ulps(dr, w[1])
    for got, want in ((ds, w[2]), (dt, w[3])):
        want = _f32(want).reshape(-1)
        assert onp.abs(got.numpy() - want).max() <= \
            SUM_REL * onp.abs(want).max()


def _jax_epilogue_vjp(x, s, t, r, ct, axis):
    @jax.jit
    def run(a, ss, tt, rr, c):
        y, vjp = jax.vjp(lambda *v: FN.fused_bn_add_relu_epilogue(*v, axis),
                         a, ss, tt, rr)
        return (y,) + vjp(c)
    return run(jnp.asarray(x, jnp.float16), jnp.asarray(s), jnp.asarray(t),
               jnp.asarray(r, jnp.float16), jnp.asarray(ct, jnp.float16))


@pytest.mark.parametrize("layout,shape,axis,offset", [
    ("nchw", (2, 5, 3, 4), 1, 0),
    ("nhwc", (2, 3, 4, 16), 3, 0),
    ("ragged", (3, 7, 5), 1, 0),
    # operands that start one element past an aligned address (the
    # kernels' scalar path on the card)
    ("unaligned", (2, 8, 3, 3), 1, 1),
])
def test_epilogue_nd_forward_and_backward_match_jax(layout, shape, axis,
                                                    offset):
    """The differentiable N-D entry against the JAX package's, NCHW, NHWC, a
    ragged and an unaligned case: y, dx and dresidual within 1 ulp, dscale
    and dshift (carried to the fp32 vectors) within 1e-5 relative."""
    c = shape[axis]
    x, r, ct = (_rand(shape, 10 + i, 4) for i in range(3))
    s, t = _rand((c,), 13) + 1.0, _rand((c,), 14)
    n = int(onp.prod(shape))

    def half(a):
        buf = torch.zeros(n + offset, dtype=torch.float16)
        buf[offset:] = torch.from_numpy(a.reshape(-1))
        return buf[offset:].view(shape).requires_grad_()
    tx, tr = half(x), half(r)
    ts = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    y = TFN.fused_bn_add_relu_epilogue(tx, ts, tt, tr, axis)
    assert y.dtype == torch.float16
    got = torch.autograd.grad(y, (tx, ts, tt, tr),
                              torch.from_numpy(ct).half())
    want = _jax_epilogue_vjp(x, s, t, r, ct, axis)
    assert _within_ulps(y.detach(), want[0])
    assert _within_ulps(got[0], want[1]) and _within_ulps(got[3], want[4])
    assert _dt(got[0]) == _dt(got[3]) == "float16"
    for g, w in ((got[1], want[2]), (got[2], want[3])):
        w = _f32(w)
        assert g.dtype == torch.float32
        assert onp.abs(g.numpy() - w).max() <= SUM_REL * onp.abs(w).max()


def test_epilogue_overflows_to_inf_as_astype():
    x = onp.full((2, 3), 40000.0, "float32")
    s, t = onp.full((3,), 2.0, "float32"), onp.zeros(3, "float32")
    port = TFN.fused_scale_shift_add_relu(
        torch.from_numpy(x).half(), torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(x).half())
    want = FN._jnp_epilogue(jnp.asarray(x, jnp.float16), jnp.asarray(s[None]),
                            jnp.asarray(t[None]), jnp.asarray(x, jnp.float16))
    assert torch.isinf(port).all() and onp.isinf(_f32(want)).all()


# --------------------------------------------------------------- LayerNorm

def _ln_inputs(seed, shape, x_dtype, g_dtype):
    rs = onp.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 3 + 1.5).astype("float32")
    g = rs.uniform(0.5, 1.5, shape[-1]).astype("float32")
    b = rs.uniform(-0.5, 0.5, shape[-1]).astype("float32")
    ct = rs.standard_normal(shape).astype("float32")
    j = (jnp.asarray(x, x_dtype), jnp.asarray(g, g_dtype),
         jnp.asarray(b, g_dtype))
    t = (torch.from_numpy(x).to(getattr(torch, x_dtype)),
         torch.from_numpy(g).to(getattr(torch, g_dtype)),
         torch.from_numpy(b).to(getattr(torch, g_dtype)))
    return j, t, ct


PAIRS = [(x, g) for x in DTYPES for g in DTYPES
         if "float16" in (x, g)]


@pytest.mark.parametrize("x_dtype,g_dtype", PAIRS)
def test_layernorm_fwd_matches_pallas_interpret(x_dtype, g_dtype):
    """Every pair of x and gamma/beta dtypes with float16 in it: y in their
    promotion (f16 with f16 gives f16, f16 with f32 or bf16 gives f32),
    mu and rstd fp32."""
    (jx, jg, jb), (tx, tg, tb), _ = _ln_inputs(0, (24, 64), x_dtype,
                                               g_dtype)
    want_y, want_mu, want_rs = JL.pallas_layer_norm_fwd(jx, jg, jb, 1e-5,
                                                        interpret=True)
    y, mu, rstd = TL._layer_norm_fwd_plain(tx, tg, tb, 1e-5)
    out = str(jnp.result_type(jx.dtype, jg.dtype))
    assert _dt(y) == str(want_y.dtype) == out
    assert out == ("float16" if x_dtype == g_dtype else "float32")
    assert _dt(mu) == _dt(rstd) == "float32"
    onp.testing.assert_allclose(mu.numpy(), _f32(want_mu), rtol=1e-5,
                                atol=F32_ATOL)
    onp.testing.assert_allclose(rstd.numpy(), _f32(want_rs), rtol=1e-5)
    got, want = y.float().numpy(), _f32(want_y)
    assert (onp.abs(got - want) <= _ulp_tol(got, want, out)).all()


@pytest.mark.parametrize("x_dtype,g_dtype", PAIRS)
def test_layernorm_bwd_matches_pallas_interpret(x_dtype, g_dtype):
    """dx in x's dtype, dgamma and dbeta fp32, from ct in y's dtype."""
    (jx, jg, jb), (tx, tg, _), ct = _ln_inputs(1, (40, 48), x_dtype,
                                               g_dtype)
    y_dtype = jnp.result_type(jx.dtype, jg.dtype)
    _, mu, rstd = JL.pallas_layer_norm_fwd(jx, jg, jb, 1e-5, block_rows=16,
                                           interpret=True)
    want = JL.pallas_layer_norm_bwd(jx, jg, mu, rstd,
                                    jnp.asarray(ct, y_dtype), block_rows=16,
                                    interpret=True)
    got = TL.layer_norm_bwd(tx, tg, torch.from_numpy(_f32(mu)),
                            torch.from_numpy(_f32(rstd)),
                            torch.from_numpy(ct).to(getattr(torch,
                                                            str(y_dtype))))
    assert [_dt(v) for v in got] == [x_dtype, "float32", "float32"]
    assert [str(w.dtype) for w in want] == [x_dtype, "float32", "float32"]
    dx, wdx = got[0].float().numpy(), _f32(want[0])
    assert (onp.abs(dx - wdx) <= _ulp_tol(dx, wdx, x_dtype)).all()
    for a, w in zip(got[1:], want[1:]):
        w = _f32(w)
        assert onp.abs(a.numpy() - w).max() <= SUM_REL * onp.abs(w).max()


@pytest.mark.parametrize("x_dtype,g_dtype", [("float16", "float16"),
                                             ("float16", "float32"),
                                             ("bfloat16", "float16")])
def test_fused_layer_norm_grads_match_jax(x_dtype, g_dtype):
    """The autograd Function against ``jax.vjp`` of the JAX package's
    fused op (its jnp path on the CPU): y and the gradients in the dtypes
    of the JAX package's, dgamma and dbeta cast to gamma's and beta's."""
    (jx, jg, jb), (tx, tg, tb), ct = _ln_inputs(2, (3, 11, 64), x_dtype,
                                                g_dtype)
    y_dtype = jnp.result_type(jx.dtype, jg.dtype)

    @jax.jit
    def run(a, gg, bb, c):
        y, vjp = jax.vjp(
            lambda a_, g_, b_: JL.fused_layer_norm(a_, g_, b_, 1e-5),
            a, gg, bb)
        return (y,) + vjp(c)
    want = run(jx, jg, jb, jnp.asarray(ct, y_dtype))
    tx, tg, tb = (v.requires_grad_() for v in (tx, tg, tb))
    out = TL.fused_layer_norm(tx, tg, tb, 1e-5)
    got = (out,) + torch.autograd.grad(out, (tx, tg, tb),
                                       torch.from_numpy(ct).to(out.dtype))
    for name, a, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert _dt(a) == str(w.dtype), name
        a, w = a.detach().float().numpy(), _f32(w)
        assert onp.abs(a - w).max() <= JNP_REL * onp.abs(w).max(), name


@pytest.mark.parametrize("fused", ["0", "1"])
def test_layer_norm_op_in_float16_matches_jax(monkeypatch, fused):
    """The ``LayerNorm`` op on float16 data and affine, on both routes: the
    composed one (one-pass fp32 statistics, the normalised values cast
    back, the affine in float16) and the kernel route."""
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", fused)
    (jx, jg, jb), (tx, tg, tb), _ = _ln_inputs(3, (2, 7, 96), "float16",
                                               "float16")
    want = jnn.layer_norm(jx, jg, jb, eps=1e-5)
    got = tnn.layer_norm(tx, tg, tb, eps=1e-5)
    assert _dt(got) == str(want.dtype) == "float16"
    got, want = got.float().numpy(), _f32(want)
    assert onp.abs(got - want).max() <= JNP_REL * onp.abs(want).max()


def test_layernorm_overflows_to_inf_as_astype():
    """gamma 30000 and beta 60000: rows' values past 65504 become inf on
    both sides, the others stay finite and agree."""
    (jx, _, _), (tx, _, _), _ = _ln_inputs(4, (4, 32), "float16", "float16")
    g, b = onp.full(32, 30000.0, "float32"), onp.full(32, 60000.0, "float32")
    want, _, _ = JL.pallas_layer_norm_fwd(
        jx, jnp.asarray(g, jnp.float16), jnp.asarray(b, jnp.float16), 1e-5,
        interpret=True)
    y, _, _ = TL._layer_norm_fwd_plain(tx, torch.from_numpy(g).half(),
                                       torch.from_numpy(b).half(), 1e-5)
    got, want = y.float().numpy(), _f32(want)
    inf = onp.isinf(want)
    assert inf.any() and (~inf).any()
    onp.testing.assert_array_equal(onp.isinf(got), inf)
    assert (onp.abs(got[~inf] - want[~inf])
            <= _ulp_tol(got[~inf], want[~inf], "float16")).all()
