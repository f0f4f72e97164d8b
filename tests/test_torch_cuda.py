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
