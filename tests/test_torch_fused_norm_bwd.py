"""Port parity: the backward of the BN -> add -> ReLU epilogue.

The plain backward of ``mxnet_tpu_torch`` against the JAX package's Pallas
backward kernel (``pallas_epilogue_bwd`` in interpret mode, as
tests/test_fused_bn_epilogue.py runs it on the CPU; 2-D operands, i.e.
trail 1) and against ``jax.vjp`` of the JAX N-D entry (NCHW, NHWC and a
ragged 3-D case), and the autograd Function that joins the two kernels.

Tolerances: dx and dresidual within 1e-6 absolute in float32 (both sides
compute ``g * scale`` once in fp32) and within 1 bf16 ulp in bfloat16 (the
same fp32 value rounded once); dscale and dshift within rel 1e-5 of the
largest entry of their vector, because only the order of the channel sums
differs and a channel whose terms cancel has a sum near zero.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_fused_norm as FN
from mxnet_tpu_torch.ops import fused_norm as TFN


def _rand(shape, seed):
    return onp.random.RandomState(seed).uniform(-1, 1, shape).astype("float32")


def _operands(shape, axis, seed):
    c = shape[axis]
    return (_rand(shape, seed), _rand((c,), seed + 1) + 1.5,
            _rand((c,), seed + 2) * 0.2, _rand(shape, seed + 3),
            _rand(shape, seed + 4))


def _port_bwd(x, s, t, r, ct, axis, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype)
    rt = torch.from_numpy(r).to(dtype)
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    y = TFN.fused_bn_add_relu_epilogue_plain(xt, st, tt, rt, axis)
    return TFN.fused_bn_add_relu_epilogue_bwd_plain(
        xt, st, y, torch.from_numpy(ct).to(dtype), axis)


def _close_vec(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    onp.testing.assert_allclose(got, want, rtol=1e-5,
                                atol=1e-5 * onp.abs(want).max())


def _bf16_bits(a):
    """bfloat16 values as 16-bit patterns, -0 read as +0 (JAX's vjp of
    the ReLU gives -0 where the cotangent is negative and masked)."""
    if isinstance(a, torch.Tensor):
        bits = a.view(torch.int16).numpy().view(onp.uint16)
    else:
        bits = onp.asarray(a).view(onp.uint16)
    bits = bits.astype(onp.int64)
    return onp.where(bits == 0x8000, 0, bits)


@pytest.mark.parametrize("rows,cols", [(70, 200), (3, 37)])
def test_plain_bwd_matches_pallas_interpret(rows, cols):
    x, s, t, r, ct = _operands((rows, cols), 1, 0)
    dx, dr, ds, dt = _port_bwd(x, s, t, r, ct, 1)
    s_row = jnp.asarray(s[None])
    y = FN.pallas_epilogue_fwd(jnp.asarray(x), s_row, jnp.asarray(t[None]),
                               jnp.asarray(r), interpret=True)
    want = FN.pallas_epilogue_bwd(jnp.asarray(x), s_row, y, jnp.asarray(ct),
                                  interpret=True)
    onp.testing.assert_allclose(dx.numpy(), onp.asarray(want[0]), rtol=0,
                                atol=1e-6)
    onp.testing.assert_allclose(dr.numpy(), onp.asarray(want[1]), rtol=0,
                                atol=1e-6)
    _close_vec(ds.numpy(), onp.asarray(want[2])[0])
    _close_vec(dt.numpy(), onp.asarray(want[3])[0])


def _jax_vjp(x, s, t, r, ct, axis, dtype=jnp.float32):
    def f(xx, ss, tt, rr):
        return FN.fused_bn_add_relu_epilogue(xx, ss, tt, rr, axis)
    _, vjp = jax.vjp(f, jnp.asarray(x, dtype), jnp.asarray(s),
                     jnp.asarray(t), jnp.asarray(r, dtype))
    return vjp(jnp.asarray(ct, dtype))


@pytest.mark.parametrize("shape,axis", [((2, 5, 3, 4), 1), ((2, 3, 4, 5), 3),
                                        ((3, 7, 5), 1)])
def test_plain_bwd_matches_jax_vjp_layouts(shape, axis):
    x, s, t, r, ct = _operands(shape, axis, 10)
    dx, dr, ds, dt = _port_bwd(x, s, t, r, ct, axis)
    jdx, jds, jdt, jdr = _jax_vjp(x, s, t, r, ct, axis)
    onp.testing.assert_allclose(dx.numpy(), onp.asarray(jdx), rtol=0,
                                atol=1e-6)
    onp.testing.assert_allclose(dr.numpy(), onp.asarray(jdr), rtol=0,
                                atol=1e-6)
    _close_vec(ds.numpy(), jds)
    _close_vec(dt.numpy(), jdt)


def test_plain_bwd_bf16_within_one_ulp_of_jax():
    shape, axis = (2, 6, 5, 5), 1
    x, s, t, r, ct = _operands(shape, axis, 20)
    dx, dr, _, _ = _port_bwd(x, s, t, r, ct, axis, torch.bfloat16)
    assert dx.dtype == dr.dtype == torch.bfloat16
    jdx, _, _, jdr = _jax_vjp(x, s, t, r, ct, axis, jnp.bfloat16)
    assert onp.abs(_bf16_bits(dx) - _bf16_bits(jdx)).max() <= 1
    assert onp.abs(_bf16_bits(dr) - _bf16_bits(jdr)).max() <= 1


def test_function_gradcheck_float64():
    """The Function's gradients in all four operands, through the plain
    versions, against finite differences (float64 keeps float64)."""
    g = torch.Generator().manual_seed(0)
    shape = (2, 3, 2, 2)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    r = torch.randn(shape, generator=g, dtype=torch.float64)
    s = torch.rand(3, generator=g, dtype=torch.float64) + 0.5
    t = torch.randn(3, generator=g, dtype=torch.float64) * 0.1
    # keep the pre-ReLU values away from the kink at 0
    pre = x * s.reshape(1, 3, 1, 1) + t.reshape(1, 3, 1, 1) + r
    r = torch.where(pre.abs() < 0.05, r + 0.2, r)
    inputs = [a.requires_grad_() for a in (x, s, t, r)]
    assert TFN.fused_bn_add_relu_epilogue(*inputs, 1).dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda a, b, c, d: TFN.fused_bn_add_relu_epilogue(a, b, c, d, 1),
        inputs)


def test_function_data_gets_both_paths_through_batch_stats():
    """Through BatchNormAddRelu the data's gradient is the kernel's dx plus
    what flows back through the batch statistics: it matches the same
    function composed of plain torch ops under autograd."""
    from mxnet_tpu_torch.ops import nn as tnn
    x, _, _, r, ct = _operands((3, 4, 2, 2), 1, 30)
    gamma = torch.from_numpy(_rand((4,), 31) + 1.5)
    beta = torch.from_numpy(_rand((4,), 32))

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        gt, bt = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        out = fn(xt, gt, bt)
        out.backward(torch.from_numpy(ct))
        return xt.grad, gt.grad, bt.grad

    def fused(xt, gt, bt):
        return tnn.batch_norm_add_relu(
            xt, torch.from_numpy(r), gt, bt, torch.zeros(4), torch.ones(4),
            eps=1e-5, fix_gamma=False)[0]

    def composed(xt, gt, bt):
        out, _, _ = tnn.batch_norm(xt, gt, bt, torch.zeros(4), torch.ones(4),
                                   eps=1e-5, fix_gamma=False)
        return torch.relu(out + torch.from_numpy(r))

    for a, b in zip(grads(fused), grads(composed)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_never_count_a_launch():
    x, s, t, r, ct = (torch.from_numpy(a)
                      for a in _operands((2, 3, 4), 1, 40))
    fwd, bwd = TFN.LAUNCHES, TFN.BWD_LAUNCHES
    xg = x.clone().requires_grad_()
    TFN.fused_bn_add_relu_epilogue(xg, s, t, r, 1).backward(ct)
    y = TFN.fused_bn_add_relu_epilogue_plain(x, s, t, r, 1)
    got = TFN.fused_bn_add_relu_epilogue_bwd(x, s, y, ct, 1)
    want = TFN.fused_bn_add_relu_epilogue_bwd_plain(x, s, y, ct, 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(xg.grad, want[0], rtol=0, atol=0)
    assert (TFN.LAUNCHES, TFN.BWD_LAUNCHES) == (fwd, bwd)
