"""Port parity: the LayerNorm backward of ``mxnet_tpu_torch`` against the
JAX package's.

The plain version of the port's backward kernel
(``_layer_norm_bwd_plain``, what the wrapper runs for CPU tensors) against
the JAX package's Pallas backward in interpret mode (32-row blocks, as
tests/test_pallas_layernorm.py runs it), on the same x, gamma, mu, rstd
and cotangent: float32 and bfloat16 x, float32 and bfloat16 gamma, a row
count that is not a multiple of the block.  dx within 1e-5 absolute in
float32 (the same fp32 arithmetic, row means summed in another order) and
within 1e-5 plus one bf16 ulp of the larger value in bfloat16 (fp32 values
that agree within 1e-5, each rounded once); dgamma and dbeta, fp32 sums
over the rows, within rel 1e-5 of their largest entry.

The port's autograd Function (``fused_layer_norm`` with a recorded
gradient) against ``jax.vjp`` of the JAX package's ``fused_layer_norm``,
which composes LayerNorm on the CPU: float32 within 1e-5 absolute for dx
and 1e-5 relative for dgamma/dbeta; bfloat16 within 2e-2 of the largest
entry (the composed form rounds the normalised values to bf16 before the
affine, the kernel route once at the end), the gradients in the dtypes
of x, gamma and beta on both sides.
"""
import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_layernorm as JL
from mxnet_tpu_torch.ops import layernorm as TL

F32_ATOL, SUM_REL, BF16_REL = 1e-5, 1e-5, 2e-2


def _inputs(seed, shape, x_dtype, g_dtype):
    rs = onp.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 3 + 1.5).astype("float32")
    g = rs.uniform(0.5, 1.5, shape[-1]).astype("float32")
    b = rs.uniform(-0.5, 0.5, shape[-1]).astype("float32")
    ct = rs.standard_normal(shape).astype("float32")
    return x, g, b, ct


def _f32(a):
    return onp.array(jnp.asarray(a, jnp.float32))


def _dt(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("n,c,x_dtype,g_dtype", [
    (37, 100, "float32", "float32"),
    (50, 64, "bfloat16", "bfloat16"),
    (24, 64, "bfloat16", "float32"),
    (9, 48, "float32", "bfloat16"),
])
def test_plain_matches_pallas_interpret(n, c, x_dtype, g_dtype):
    x, g, b, ct = _inputs(0, (n, c), x_dtype, g_dtype)
    y_dtype = jnp.result_type(jnp.dtype(x_dtype), jnp.dtype(g_dtype))
    jx, jg, jb = (jnp.asarray(x, x_dtype), jnp.asarray(g, g_dtype),
                  jnp.asarray(b, g_dtype))
    jct = jnp.asarray(ct, y_dtype)
    _, mu, rstd = JL.pallas_layer_norm_fwd(jx, jg, jb, 1e-5, block_rows=32,
                                           interpret=True)
    want = JL.pallas_layer_norm_bwd(jx, jg, mu, rstd, jct, block_rows=32,
                                    interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tg = torch.from_numpy(g).to(getattr(torch, g_dtype))
    tct = torch.from_numpy(ct).to(getattr(torch, str(y_dtype)))
    got = TL._layer_norm_bwd_plain(tx, tg, torch.from_numpy(_f32(mu)),
                                   torch.from_numpy(_f32(rstd)), tct)
    assert [_dt(t) for t in got] == [x_dtype, "float32", "float32"]
    assert [tuple(t.shape) for t in got] == [(n, c), (c,), (c,)]
    dx, wdx = got[0].float().numpy(), _f32(want[0])
    tol = F32_ATOL
    if x_dtype == "bfloat16":
        _, e = onp.frexp(onp.maximum(onp.abs(dx), onp.abs(wdx)))
        tol = tol + onp.ldexp(1.0, e - 8)
    assert (onp.abs(dx - wdx) <= tol).all()
    for a, w in zip(got[1:], want[1:]):
        w = _f32(w)
        assert onp.abs(a.numpy() - w).max() <= SUM_REL * onp.abs(w).max()


def test_wrapper_runs_the_plain_version_on_cpu():
    x, g, b, ct = (torch.from_numpy(a) for a in
                   _inputs(1, (5, 40), "float32", "float32"))
    _, mu, rstd = TL.layer_norm_fwd(x, g, b, 1e-5)
    before = TL.BWD_LAUNCHES
    got = TL.layer_norm_bwd(x, g, mu, rstd, ct)
    want = TL._layer_norm_bwd_plain(x, g, mu, rstd, ct)
    assert TL.BWD_LAUNCHES == before          # no kernel on the CPU
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_wrapper_raises_for_a_device_without_a_kernel():
    x = torch.zeros((4, 8), device="meta")
    stat = torch.zeros((4, 1), device="meta")
    with pytest.raises(TL.MXNetError, match="no kernel for device"):
        TL.layer_norm_bwd(x, x[0], stat, stat, x)


@pytest.mark.parametrize("shape,x_dtype,g_dtype", [
    ((2, 7, 96), "float32", "float32"),
    ((3, 11, 64), "bfloat16", "bfloat16"),
    ((37, 64), "bfloat16", "float32"),
    ((5, 48), "float32", "bfloat16"),
])
def test_function_grads_match_jax_vjp(shape, x_dtype, g_dtype):
    x, g, b, ct = _inputs(2, shape, x_dtype, g_dtype)
    jx, jg, jb = (jnp.asarray(x, x_dtype), jnp.asarray(g, g_dtype),
                  jnp.asarray(b, g_dtype))
    y_dtype = jnp.result_type(jx.dtype, jg.dtype)

    @jax.jit
    def grads(a, gg, bb, c):
        _, vjp = jax.vjp(
            lambda a_, g_, b_: JL.fused_layer_norm(a_, g_, b_, 1e-5),
            a, gg, bb)
        return vjp(c)
    want = grads(jx, jg, jb, jnp.asarray(ct, y_dtype))
    tx, tg, tb = (torch.from_numpy(a).to(getattr(torch, dt))
                  .requires_grad_()
                  for a, dt in ((x, x_dtype), (g, g_dtype), (b, g_dtype)))
    out = TL.fused_layer_norm(tx, tg, tb, 1e-5)
    assert _dt(out) == str(y_dtype)
    got = torch.autograd.grad(out, (tx, tg, tb),
                              torch.from_numpy(ct).to(out.dtype))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        assert _dt(a) == str(w.dtype), name
        a, w = a.float().numpy(), _f32(w)
        if x_dtype == g_dtype == "float32":
            tol = F32_ATOL if name == "dx" else SUM_REL * onp.abs(w).max()
        else:
            tol = BF16_REL * onp.abs(w).max()
        assert onp.abs(a - w).max() <= tol, name
