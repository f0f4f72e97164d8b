"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on CUDA tensors.  Marked ``cuda``; each test skips where there is
no CUDA device.  This file imports neither JAX nor the JAX package, so on
a machine with the card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from mxnet_tpu_torch.ops import fused_norm as TFN


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """On the card: the CUDA kernel against the plain version, f32 bitwise
    (the kernel rounds each operation as the plain version does) and bf16
    within 1 ulp, aligned and unaligned, and counted as launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    n_launches = 0
    for shape, axis, dtype in [((2, 64, 7, 7), 1, torch.float32),
                               ((3, 5, 5, 24), 3, torch.bfloat16),
                               ((1, 3, 37), 1, torch.float32)]:
        n = 1
        for d in shape:
            n *= d
        s = torch.randn(shape[axis], device=dev, generator=g)
        t = torch.randn(shape[axis], device=dev, generator=g)
        for off in (0, 1):       # off=1: unaligned pointers, scalar path
            x = torch.randn(n + off, device=dev, generator=g).to(dtype)
            r = torch.randn(n + off, device=dev, generator=g).to(dtype)
            x, r = x[off:].view(shape), r[off:].view(shape)
            before = TFN.LAUNCHES
            y = TFN.fused_bn_add_relu_epilogue(x, s, t, r, axis)
            torch.cuda.synchronize()
            assert TFN.LAUNCHES == before + 1
            n_launches += 1
            want = TFN.fused_bn_add_relu_epilogue_plain(x, s, t, r, axis)
            if dtype == torch.float32:
                assert torch.equal(y, want)
            else:
                diff = y.view(torch.int16).int() - want.view(torch.int16).int()
                assert diff.abs().max().item() <= 1
    assert n_launches == 6


@pytest.mark.cuda
def test_bwd_kernel_matches_plain_on_cuda():
    """On the card: the backward kernel against the plain backward, dx and
    dresidual bitwise in f32 (the same fp32 product) and within 1 ulp in
    bf16, dscale/dshift within rel 1e-5 of their largest entry (summation
    order), the same bits on a second run (no atomics), NCHW with a
    trail that is not a multiple of 4 and NHWC, counted as launches; and
    the autograd Function through both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    for shape, axis, dtype in [((4, 64, 7, 7), 1, torch.float32),
                               ((3, 5, 5, 40), 3, torch.bfloat16),
                               ((2, 3, 37), 1, torch.float32),
                               ((96, 24), 1, torch.float32)]:
        c = shape[axis]
        x = torch.randn(shape, device=dev, generator=g).to(dtype)
        r = torch.randn(shape, device=dev, generator=g).to(dtype)
        ct = torch.randn(shape, device=dev, generator=g).to(dtype)
        s = torch.rand(c, device=dev, generator=g) + 0.5
        t = torch.randn(c, device=dev, generator=g) * 0.1
        y = TFN.fused_bn_add_relu_epilogue_plain(x, s, t, r, axis)
        before = TFN.BWD_LAUNCHES
        got = TFN.fused_bn_add_relu_epilogue_bwd(x, s, y, ct, axis)
        again = TFN.fused_bn_add_relu_epilogue_bwd(x, s, y, ct, axis)
        torch.cuda.synchronize()
        assert TFN.BWD_LAUNCHES == before + 2
        want = TFN.fused_bn_add_relu_epilogue_bwd_plain(x, s, y, ct, axis)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for a, b in zip(got[:2], want[:2]):
            if dtype == torch.float32:
                assert torch.equal(a, b)
            else:
                diff = a.view(torch.int16).int() - b.view(torch.int16).int()
                assert diff.abs().max().item() <= 1
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == torch.float32
            tol = 1e-5 * b.abs().max().item()
            assert (a - b).abs().max().item() <= tol
    xg = torch.randn((2, 8, 3, 3), device=dev, generator=g).requires_grad_()
    sg = (torch.rand(8, device=dev, generator=g) + 0.5).requires_grad_()
    tg = torch.zeros(8, device=dev).requires_grad_()
    rg = torch.randn((2, 8, 3, 3), device=dev, generator=g).requires_grad_()
    fwd, bwd = TFN.LAUNCHES, TFN.BWD_LAUNCHES
    TFN.fused_bn_add_relu_epilogue(xg, sg, tg, rg, 1).sum().backward()
    assert (TFN.LAUNCHES, TFN.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    grads = [a.grad.clone() for a in (xg, sg, tg, rg)]
    cpu = [a.detach().cpu().requires_grad_() for a in (xg, sg, tg, rg)]
    TFN.fused_bn_add_relu_epilogue(*cpu, 1).sum().backward()
    for got, ref in zip(grads, cpu):
        torch.testing.assert_close(got.cpu(), ref.grad, rtol=1e-5, atol=1e-5)
