"""Port parity: LayerNorm of ``mxnet_tpu_torch`` against the JAX package's.

The plain version of the port's kernel (``_layer_norm_fwd_plain``, what the
wrapper runs for CPU tensors) against the JAX package's Pallas forward in
interpret mode: y, mu and rstd, with float32 and bfloat16 x and both
dtypes of gamma/beta (y's dtype is their promotion).  Tolerances: float32
within 1e-5 absolute (the same fp32 arithmetic, summed in another order);
bfloat16 y within 1e-5 plus one bf16 ulp of the larger value (fp32 values
that agree within 1e-5, each rounded once), mu and rstd within 1e-5
relative.

The ``LayerNorm`` op on both of its routes against the JAX package's op:
``MXNET_FUSED_LAYERNORM`` unset (composed: two-pass in float32, one-pass
fp32 statistics for bfloat16) and set (the port's kernel route; the JAX
package composes on the CPU, rounding the normalised values to the data
dtype before the affine).  float32 within 1e-5; bfloat16 within 1e-2 of
the largest |y|: the two rounding orders differ by a bf16 ulp or two of
a value (2**-8 of it each), 3.2e-3 at most in these cases.
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_layernorm as JL
from mxnet_tpu_torch.ops import layernorm as TL
from mxnet_tpu_torch.ops import nn as tnn

F32_ATOL, BF16_REL = 1e-5, 1e-2


def _inputs(seed, shape, x_dtype, g_dtype, axis=-1):
    rs = onp.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 3 + 1.5).astype("float32")
    g = rs.uniform(0.5, 1.5, shape[axis]).astype("float32")
    b = rs.uniform(-0.5, 0.5, shape[axis]).astype("float32")
    j = (jnp.asarray(x, x_dtype), jnp.asarray(g, g_dtype),
         jnp.asarray(b, g_dtype))
    t = (torch.from_numpy(x).to(getattr(torch, x_dtype)),
         torch.from_numpy(g).to(getattr(torch, g_dtype)),
         torch.from_numpy(b).to(getattr(torch, g_dtype)))
    return j, t


def _f32(a):
    return onp.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,x_dtype,g_dtype", [
    ((37, 100), "float32", "float32"),
    ((24, 64), "bfloat16", "bfloat16"),
    ((24, 64), "bfloat16", "float32"),
    ((9, 48), "float32", "bfloat16"),
])
def test_plain_matches_pallas_interpret(shape, x_dtype, g_dtype):
    (jx, jg, jb), (tx, tg, tb) = _inputs(0, shape, x_dtype, g_dtype)
    want_y, want_mu, want_rs = JL.pallas_layer_norm_fwd(jx, jg, jb, 1e-5,
                                                        interpret=True)
    y, mu, rstd = TL._layer_norm_fwd_plain(tx, tg, tb, 1e-5)
    assert str(y.dtype).replace("torch.", "") == str(want_y.dtype)
    assert mu.shape == (shape[0], 1) and rstd.dtype == torch.float32
    onp.testing.assert_allclose(mu.numpy(), _f32(want_mu), rtol=1e-5,
                                atol=F32_ATOL)
    onp.testing.assert_allclose(rstd.numpy(), _f32(want_rs), rtol=1e-5)
    got, want = y.float().numpy(), _f32(want_y)
    tol = F32_ATOL
    if y.dtype == torch.bfloat16:
        _, e = onp.frexp(onp.maximum(onp.abs(got), onp.abs(want)))
        tol = tol + onp.ldexp(1.0, e - 8)
    assert (onp.abs(got - want) <= tol).all()


def test_wrapper_runs_the_plain_version_on_cpu():
    _, (x, g, b) = _inputs(1, (5, 40), "float32", "float32")
    before = TL.LAUNCHES
    got = TL.layer_norm_fwd(x, g, b, 1e-5)
    want = TL._layer_norm_fwd_plain(x, g, b, 1e-5)
    assert TL.LAUNCHES == before
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("shape,x_dtype,g_dtype,axis", [
    ((2, 7, 96), "float32", "float32", -1),
    ((2, 7, 96), "bfloat16", "bfloat16", -1),
    ((3, 64), "bfloat16", "float32", -1),
    ((4, 6, 5), "float32", "float32", 1),
])
def test_layer_norm_op_matches_jax(monkeypatch, fused, shape, x_dtype,
                                   g_dtype, axis):
    """Both routes of the op, with the opt-in variable unset and set."""
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", fused)
    (jx, jg, jb), (tx, tg, tb) = _inputs(2, shape, x_dtype, g_dtype, axis)
    want = jnn.layer_norm(jx, jg, jb, axis=axis, eps=1e-5)
    got = tnn.layer_norm(tx, tg, tb, axis=axis, eps=1e-5)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    got, want = got.float().numpy(), _f32(want)
    if x_dtype == "float32" and g_dtype == "float32":
        onp.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        err = onp.abs(got - want).max() / onp.abs(want).max()
        assert err <= BF16_REL, err


def test_fused_route_takes_the_kernel_only_up_to_its_channel_limit(
        monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    calls = []
    orig = TL.layer_norm_fwd
    monkeypatch.setattr(TL, "layer_norm_fwd",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    for c, kernel_route in ((TL.MAX_CHANNELS, True),
                            (TL.MAX_CHANNELS + 52, False)):
        (jx, jg, jb), (tx, tg, tb) = _inputs(3, (2, c), "float32", "float32")
        del calls[:]
        got = tnn.layer_norm(tx, tg, tb, eps=1e-5)
        assert calls == ([(2, c)] if kernel_route else [])
        want = JL._jnp_ln(jx, jg, jb, 1e-5)
        onp.testing.assert_allclose(got.numpy(), _f32(want), rtol=0,
                                    atol=F32_ATOL)
