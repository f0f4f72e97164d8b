"""Port parity: the BN -> add -> ReLU epilogue of ``mxnet_tpu_torch`` against
the JAX package's Pallas kernel (interpret mode, as
tests/test_fused_bn_epilogue.py runs it on the CPU) and its jnp path.

Tolerances: float32 within 1e-6 absolute (both sides compute the same fp32
multiply and adds; only an FMA contraction can move the last bit);
bfloat16 within 1 ulp (both round the same fp32 value once, so a 1-ulp
difference can come only from such a contraction).
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_fused_norm as FN
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import fused_norm as TFN


def _rand(shape, seed):
    return onp.random.RandomState(seed).uniform(-1, 1, shape).astype("float32")


def _operands(rows, cols, seed):
    return (_rand((rows, cols), seed), _rand((cols,), seed + 1),
            _rand((cols,), seed + 2), _rand((rows, cols), seed + 3))


def _bf16_bits(a):
    """bfloat16 values as unsigned 16-bit patterns (numpy has no bf16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(onp.uint16).astype(onp.int64)
    return onp.asarray(a).view(onp.uint16).astype(onp.int64)


@pytest.mark.parametrize("rows,cols", [(70, 200), (3, 37)])
def test_plain_matches_pallas_interpret_and_jnp_f32(rows, cols):
    x, s, t, r = _operands(rows, cols, 0)
    port = TFN.fused_scale_shift_add_relu(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(r)).numpy()
    kernel = FN.pallas_epilogue_fwd(jnp.asarray(x), jnp.asarray(s[None]),
                                    jnp.asarray(t[None]), jnp.asarray(r),
                                    interpret=True)
    ref = FN._jnp_epilogue(jnp.asarray(x), jnp.asarray(s[None]),
                           jnp.asarray(t[None]), jnp.asarray(r))
    assert port.dtype == onp.float32
    onp.testing.assert_allclose(port, onp.asarray(kernel), rtol=0, atol=1e-6)
    onp.testing.assert_allclose(port, onp.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,cols", [(70, 200), (3, 37)])
def test_plain_matches_pallas_interpret_and_jnp_bf16(rows, cols):
    x, s, t, r = _operands(rows, cols, 10)
    xj = jnp.asarray(x, jnp.bfloat16)
    rj = jnp.asarray(r, jnp.bfloat16)
    port = TFN.fused_scale_shift_add_relu(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s),
        torch.from_numpy(t), torch.from_numpy(r).to(torch.bfloat16))
    assert port.dtype == torch.bfloat16
    kernel = FN.pallas_epilogue_fwd(xj, jnp.asarray(s[None]),
                                    jnp.asarray(t[None]), rj, interpret=True)
    ref = FN._jnp_epilogue(xj, jnp.asarray(s[None]), jnp.asarray(t[None]), rj)
    got = _bf16_bits(port)
    assert onp.abs(got - _bf16_bits(kernel)).max() <= 1
    assert onp.abs(got - _bf16_bits(ref)).max() <= 1


@pytest.mark.parametrize("shape,axis", [((2, 5, 3, 4), 1), ((2, 3, 4, 5), 3),
                                        ((3, 7, 5), 1)])
def test_nd_entry_matches_jax_layouts(shape, axis):
    """NCHW (axis=1), NHWC (axis=3) and a ragged 3-D case against the JAX
    N-D entry, with per-channel scale/shift."""
    c = shape[axis]
    x, r = _rand(shape, 20), _rand(shape, 21)
    s, t = _rand((c,), 22), _rand((c,), 23)
    port = TFN.fused_bn_add_relu_epilogue(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(r), axis).numpy()
    want = FN.fused_bn_add_relu_epilogue(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(t), jnp.asarray(r), axis)
    onp.testing.assert_allclose(port, onp.asarray(want), rtol=0, atol=1e-6)


def test_cpu_wrapper_runs_plain_without_launch():
    x, s, t, r = (torch.from_numpy(a) for a in _operands(4, 6, 30))
    before = TFN.LAUNCHES
    y = TFN.fused_bn_add_relu_epilogue(x, s, t, r, 1)
    assert TFN.LAUNCHES == before
    torch.testing.assert_close(
        y, TFN.fused_bn_add_relu_epilogue_plain(x, s, t, r, 1), rtol=0, atol=0)


def test_wrapper_refuses_grad_and_bad_shapes():
    """Operands that require grad are taken since the epilogue has a
    backward (the Function); mismatched shapes are refused."""
    x, s, t, r = (torch.from_numpy(a) for a in _operands(4, 6, 40))
    y = TFN.fused_bn_add_relu_epilogue(x.requires_grad_(), s, t, r, 1)
    y.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    with pytest.raises(ValueError):
        TFN.fused_bn_add_relu_epilogue(x.detach(), s, t, r[:2], 1)
    with pytest.raises(ValueError):
        TFN.fused_bn_add_relu_epilogue(x.detach(), s[:3], t, r, 1)
