"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on CUDA tensors.  Marked ``cuda``; each test skips where there is
no CUDA device.  This file imports neither JAX nor the JAX package, so on
a machine with the card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.ops import fused_norm as TFN
from mxnet_tpu_torch.ops import layernorm as TL


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


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_on_cuda():
    """On the card: the flash-attention kernel against the plain version,
    f32 o within 2e-5 and lse within 1e-5, bf16 o within 2e-2 of the
    largest |o| (P rounded to bf16 against the running max in the kernel,
    the row max in the plain version); masks, padded D and Tq != Tk, and
    the edges of the bf16 kernel's tile ring (Tk of 1, 63 and 129, kv_lens
    on a tile edge and 0, causal with Tq != Tk, D 128 at T 1024, D 80);
    counted as launches, also where q requires grad; bad operands
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [  # B, H, Tq, Tk, D, dtype, causal, lens, segments
        (2, 3, 200, 200, 64, torch.bfloat16, False, (0, 500), False),
        (2, 3, 130, 70, 32, torch.float32, True, None, False),
        (1, 2, 96, 160, 128, torch.bfloat16, False, None, True),
        (2, 2, 128, 128, 64, torch.float32, True, (100, 128), True),
        (2, 3, 64, 1, 64, torch.bfloat16, False, None, False),
        (2, 3, 100, 63, 64, torch.bfloat16, False, None, False),
        (2, 3, 130, 129, 64, torch.bfloat16, False, (128, 129), False),
        (3, 4, 256, 256, 64, torch.bfloat16, False, (64, 128, 0), False),
        (2, 3, 96, 200, 64, torch.bfloat16, True, None, False),
        (2, 3, 200, 96, 64, torch.bfloat16, True, (96, 50), False),
        (1, 12, 1024, 1024, 128, torch.bfloat16, False, None, False),
        (2, 3, 256, 256, 80, torch.bfloat16, False, (256, 100), False)]
    for B, H, Tq, Tk, D, dtype, causal, lens, seg in cases:
        q = (torch.rand((B, H, Tq, D), device=dev, generator=g) * 4 - 2)
        k = (torch.rand((B, H, Tk, D), device=dev, generator=g) * 4 - 2)
        v = (torch.rand((B, H, Tk, D), device=dev, generator=g) * 2 - 1)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        kw = dict(causal=causal)
        if lens is not None:
            kw["kv_lens"] = torch.tensor(lens, device=dev)
        if seg:
            kw["q_segments"] = torch.randint(0, 3, (B, Tq), device=dev,
                                             generator=g).sort(1).values
            kw["kv_segments"] = torch.randint(0, 3, (B, Tk), device=dev,
                                              generator=g).sort(1).values
        before = TA.LAUNCHES
        o, lse = TA.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        assert TA.LAUNCHES == before + 1
        want_o, want_lse = TA._flash_attention_plain(q, k, v, **kw)
        assert o.dtype == dtype and o.shape == want_o.shape
        assert (lse - want_lse).abs().max().item() <= 1e-5
        err = (o.float() - want_o.float()).abs().max().item()
        if dtype == torch.float32:
            assert err <= 2e-5, err
        else:
            assert err <= 2e-2 * want_o.float().abs().max().item(), err
        for b, n in enumerate(lens or ()):
            if n == 0:
                assert not o[b].any() and not lse[b].any()
    q = torch.zeros((1, 1, 128, 64), device=dev, requires_grad=True)
    before = TA.LAUNCHES
    TA.flash_attention_fwd(q, q, q)          # a recorded gradient runs too
    assert TA.LAUNCHES == before + 1
    x = torch.zeros((1, 1, 128, 64), device=dev)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        TA.flash_attention_fwd(x.double(), x.double(), x.double())
    with pytest.raises(MXNetError, match="contiguous"):
        t = x.transpose(2, 3)
        TA.flash_attention_fwd(t, t, t)
    with pytest.raises(MXNetError, match="head dims"):
        y = torch.zeros((1, 1, 128, 300), device=dev)
        TA.flash_attention_fwd(y, y, y)


@pytest.mark.cuda
def test_layernorm_kernel_matches_plain_on_cuda():
    """On the card: the LayerNorm kernel against the plain version, f32
    within 1e-5, bf16 within 1e-5 plus one bf16 ulp of the larger value
    (fp32 values that agree within 1e-5, their statistics summed in
    another order, each rounded once), mu and rstd within 1e-5 relative;
    vectorised, ragged and unaligned rows; counted as launches, also where
    x requires grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for (N, C), xdt, gdt, off in [((300, 768), torch.bfloat16, torch.bfloat16,
                                   0),
                                  ((37, 1000), torch.float32, torch.float32,
                                   0),
                                  ((64, 768), torch.bfloat16, torch.float32,
                                   0),
                                  ((16, 96), torch.float32, torch.bfloat16,
                                   0),
                                  ((5, 768), torch.float32, torch.float32,
                                   1)]:
        x = torch.randn(N * C + off, device=dev, generator=gen) * 3 + 1
        x = x.to(xdt)[off:].view(N, C)
        gm = (torch.rand(C, device=dev, generator=gen) + 0.5).to(gdt)
        bt = (torch.rand(C, device=dev, generator=gen) - 0.5).to(gdt)
        before = TL.LAUNCHES
        y, mu, rstd = TL.layer_norm_fwd(x, gm, bt, 1e-12)
        torch.cuda.synchronize()
        assert TL.LAUNCHES == before + 1
        wy, wmu, wrs = TL._layer_norm_fwd_plain(x, gm, bt, 1e-12)
        assert y.dtype == wy.dtype
        torch.testing.assert_close(mu, wmu, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rstd, wrs, rtol=1e-5, atol=0)
        excess = (y.float() - wy.float()).abs() - 1e-5
        if y.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(y.float().abs(),
                                             wy.float().abs()))
            excess -= torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                  e - 8)
        assert excess.max().item() <= 0
    xg = torch.ones((4, 8), device=dev, requires_grad=True)
    before = TL.LAUNCHES
    TL.layer_norm_fwd(xg, xg[0], xg[0], 1e-5)   # a recorded gradient runs
    assert TL.LAUNCHES == before + 1


def _bf16_close(got, want, rel):
    """max |got - want| within ``rel`` of the largest |want|."""
    err = (got.float() - want.float()).abs().max().item()
    return err <= rel * want.float().abs().max().item()


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_matches_plain_on_cuda():
    """On the card: the flash-attention backward kernels against the plain
    backward, f32 within 1e-5 and bf16 within 1e-2 of the largest |plain
    gradient| (p and ds rounded to bf16 from fp32 values summed in another
    order), the same bits on a second run, dk and dv exactly 0 past a
    row's valid length and dq 0 for a row that sees no key; at the edges
    of the bf16 kernels' tile ring too (Tk of 1, 63, 65 and 129, kv_lens
    on a tile edge and 0, causal with Tq != Tk, D 128 at T 1024, D 80);
    counted as launches; and the autograd Function through both kernels
    against the same Function on the CPU.  With one key a row dq and dk
    are 0 in exact arithmetic: both sides give the rounding of dp - delta,
    held to 1e-5 of the largest |dv|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    for B, H, Tq, Tk, D, dtype, causal, lens in [
            (2, 3, 200, 200, 64, bf, False, (0, 150)),
            (2, 2, 130, 70, 32, torch.float32, True, (50, 500)),
            (1, 2, 96, 160, 128, bf, True, None),
            (2, 3, 64, 1, 64, bf, False, None),
            (2, 3, 100, 63, 64, bf, False, None),
            (2, 3, 100, 65, 64, bf, False, (64, 0)),
            (2, 3, 130, 129, 64, bf, False, (128, 129)),
            (3, 4, 256, 256, 64, bf, False, (64, 128, 0)),
            (2, 3, 96, 200, 64, bf, True, None),
            (2, 3, 200, 96, 64, bf, True, (96, 50)),
            (1, 12, 1024, 1024, 128, bf, False, None),
            (2, 3, 256, 256, 80, bf, False, (256, 100))]:
        q, k, v, do = (torch.randn((B, H, T, D), device=dev, generator=g)
                       .to(dtype) for T in (Tq, Tk, Tk, Tq))
        kw = dict(causal=causal)
        if lens is not None:
            kw["kv_lens"] = torch.tensor(lens, device=dev)
        o, lse = TA.flash_attention_fwd(q, k, v, **kw)
        o = o.contiguous()
        before = TA.BWD_LAUNCHES
        got = TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert TA.BWD_LAUNCHES == before + 2
        want = TA._flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        for i, (a, b, c) in enumerate(zip(got, again, want)):
            assert torch.equal(a, b)
            assert a.dtype == dtype and a.shape == c.shape
            if Tk == 1 and i < 2:
                err = (a.float() - c.float()).abs().max().item()
                assert err <= 1e-5 * want[2].float().abs().max().item()
            else:
                assert _bf16_close(a, c, rel)
        if lens is not None:
            for b, n in enumerate(lens):
                assert not got[1][b, :, n:].any()
                assert not got[2][b, :, n:].any()
                if n == 0:
                    assert not got[0][b].any()
    qkv = [torch.randn((2, 2, 128, 32), device=dev, generator=g)
           .requires_grad_() for _ in range(3)]
    lens = torch.tensor([128, 40], device=dev)
    fwd, bwd = TA.LAUNCHES, TA.BWD_LAUNCHES
    TA.flash_attention(*qkv, causal=True, kv_lens=lens).square().sum() \
        .backward()
    assert (TA.LAUNCHES, TA.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in qkv]
    TA.flash_attention(*cpu, causal=True, kv_lens=lens.cpu()).square() \
        .sum().backward()
    for a, b in zip(qkv, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_layernorm_bwd_kernel_matches_plain_on_cuda():
    """On the card: the LayerNorm backward kernel against the plain
    backward, dx in f32 within 1e-5 and in bf16 within 1e-5 plus one bf16
    ulp of the larger value, dgamma and dbeta within rel 1e-5 of their
    largest entry, the same bits on a second run; vectorised, ragged,
    unaligned and wide rows, and the edges of the kernel's grid (one row,
    one past a block of eight, one past eight on each of 132 SMs, C 2048
    with the sums in shared memory, C 1001 one element a load); counted
    as launches; and the autograd Function through both kernels against
    the same Function on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    for (N, C), xdt, gdt, off in [((300, 768), torch.bfloat16,
                                   torch.bfloat16, 0),
                                  ((37, 1000), torch.float32, torch.float32,
                                   0),
                                  ((64, 768), torch.bfloat16, torch.float32,
                                   0),
                                  ((16, 96), torch.float32, torch.bfloat16,
                                   0),
                                  ((5, 768), torch.float32, torch.float32,
                                   1),
                                  ((33, 2048), torch.bfloat16,
                                   torch.bfloat16, 0),
                                  ((1, 768), torch.bfloat16, torch.bfloat16,
                                   0),
                                  ((9, 768), torch.bfloat16, torch.bfloat16,
                                   0),
                                  ((1057, 768), torch.bfloat16,
                                   torch.bfloat16, 0),
                                  ((4096, 2048), torch.bfloat16,
                                   torch.bfloat16, 0),
                                  ((64, 1001), torch.bfloat16,
                                   torch.bfloat16, 0)]:
        x = torch.randn(N * C + off, device=dev, generator=gen) * 3 + 1
        x = x.to(xdt)[off:].view(N, C)
        gm = (torch.rand(C, device=dev, generator=gen) + 0.5).to(gdt)
        bt = (torch.rand(C, device=dev, generator=gen) - 0.5).to(gdt)
        y, mu, rstd = TL.layer_norm_fwd(x, gm, bt, 1e-12)
        ct = torch.randn(N * C + off, device=dev, generator=gen)
        ct = ct.to(y.dtype)[off:].view(N, C)
        before = TL.BWD_LAUNCHES
        got = TL.layer_norm_bwd(x, gm, mu, rstd, ct)
        again = TL.layer_norm_bwd(x, gm, mu, rstd, ct)
        torch.cuda.synchronize()
        assert TL.BWD_LAUNCHES == before + 2
        want = TL._layer_norm_bwd_plain(x, gm, mu, rstd, ct)
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            assert a.dtype == c.dtype and a.shape == c.shape
        excess = (got[0].float() - want[0].float()).abs() - 1e-5
        if xdt == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(got[0].float().abs(),
                                             want[0].float().abs()))
            excess -= torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                  e - 8)
        assert excess.max().item() <= 0
        for a, c in zip(got[1:], want[1:]):
            assert (a - c).abs().max().item() <= 1e-5 * c.abs().max().item()
    xg = (torch.randn((6, 40), device=dev, generator=gen) * 2 + 1) \
        .requires_grad_()
    gg = (torch.rand(40, device=dev, generator=gen) + 0.5).requires_grad_()
    bg = torch.zeros(40, device=dev).requires_grad_()
    fwd, bwd = TL.LAUNCHES, TL.BWD_LAUNCHES
    TL.fused_layer_norm(xg, gg, bg, 1e-5).square().sum().backward()
    assert (TL.LAUNCHES, TL.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (xg, gg, bg)]
    TL.fused_layer_norm(*cpu, 1e-5).square().sum().backward()
    for a, b in zip((xg, gg, bg), cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_f16_and_wide_kernels_match_plain_on_cuda():
    """On the card: the float16 Hopper kernels (D 64 and 128) and the
    kernels at D 160 (padded to 192), 192 and 256 in float32, bfloat16 and
    float16, forward and backward, through both entries, against the plain
    versions: o within 2e-5 (f32), 2e-2 (bf16) and 5e-3 (f16) of the
    largest |o| (f32 absolute), lse within 1e-5; dq, dk, dv within 1e-5,
    1e-2 and 2.5e-3 of the largest |plain value|; the backward twice to
    the same bits; each call counted as one launch of its entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    o_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
    g_tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2,
             torch.float16: 2.5e-3}
    cases = [  # B, H, Tq, Tk, D, dtype, causal, lens, segments
        (2, 3, 200, 200, 64, torch.float16, False, (0, 150), True),
        (1, 4, 256, 129, 128, torch.float16, True, None, False)] + [
        (2, 2, Tq, Tk, D, dtype, causal, lens, seg)
        for dtype in (torch.float32, torch.bfloat16, torch.float16)
        for D, Tq, Tk, causal, lens, seg in (
            (160, 130, 130, False, (130, 64), False),
            (192, 100, 190, True, None, True),
            (256, 128, 97, False, (0, 97), False))]
    for B, H, Tq, Tk, D, dtype, causal, lens, seg in cases:
        what = (B, H, Tq, Tk, D, dtype)
        q, k, v, do = (
            (torch.rand((B, H, T, D), device=dev, generator=g) * 4 - 2)
            .to(dtype) for T in (Tq, Tk, Tk, Tq))
        kw = dict(causal=causal)
        if lens is not None:
            kw["kv_lens"] = torch.tensor(lens, device=dev)
        if seg:
            kw["q_segments"] = torch.randint(0, 3, (B, Tq), device=dev,
                                             generator=g).sort(1).values
            kw["kv_segments"] = torch.randint(0, 3, (B, Tk), device=dev,
                                              generator=g).sort(1).values
        for entry in ("bhtd", "bshd"):
            if entry == "bshd" and seg:
                continue
            if entry == "bhtd":
                args = (q, k, v)
                fwd, bwd = TA.flash_attention_fwd, TA.flash_attention_bwd
                counts = lambda: (TA.LAUNCHES, TA.BWD_LAUNCHES)
                pf, pb = TA._flash_attention_plain, \
                    TA._flash_attention_bwd_plain
                d_o = do
            else:
                args = tuple(t.transpose(1, 2).contiguous()
                             for t in (q, k, v))
                fwd, bwd = TA.flash_attention_bshd_fwd, \
                    TA.flash_attention_bshd_bwd
                counts = lambda: (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES)
                pf, pb = TA._flash_attention_bshd_plain, \
                    TA._flash_attention_bshd_bwd_plain
                d_o = do.transpose(1, 2).contiguous()
            before = counts()
            o, lse = fwd(*args, **kw)
            got = bwd(*args, o, lse, d_o, **kw)
            again = bwd(*args, o, lse, d_o, **kw)
            torch.cuda.synchronize()
            assert counts() == (before[0] + 1, before[1] + 2), what
            want_o, want_lse = pf(*args, **kw)
            assert o.dtype == dtype and o.shape == want_o.shape, what
            assert (lse - want_lse).abs().max().item() <= 1e-5, what
            err = (o.float() - want_o.float()).abs().max().item()
            ref = 1.0 if dtype == torch.float32 else \
                want_o.float().abs().max().item()
            assert err <= o_tol[dtype] * ref, (what, entry, err)
            want = pb(*args, o, lse, d_o, **kw)
            for a, b, w in zip(got, again, want):
                assert torch.equal(a, b), (what, entry)
                e = (a.float() - w.float()).abs().max().item()
                assert e <= g_tol[dtype] * w.float().abs().max().item(), \
                    (what, entry, e)


@pytest.mark.cuda
def test_bert_small_amp_step_on_cuda(monkeypatch):
    """On the card: one masked-LM Adam step of a small BERT (2 layers, 128
    units, 4 heads of 32) under ``amp.init("float16")``, through record,
    ``scale_loss``, backward and the Trainer with ``init_trainer``: the
    attention kernels take float16 and the LayerNorm kernels float32, one
    launch each a layer or norm, forward and backward; finite loss and
    gradients, float32 weights and Adam state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo import bert_small
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    layers, vocab, B, S, P = 2, 97, 2, 128, 5
    rs = onp.random.RandomState(0)
    gpu = mx.gpu(0)
    x = mx.nd.array(rs.randint(0, vocab, (B, S)).astype("float32"), ctx=gpu)
    vl = mx.nd.array(onp.array([S, 70], "int32"), ctx=gpu, dtype="int32")
    mp = mx.nd.array(onp.sort(rs.choice(70, (B, P), replace=False), 1)
                     .astype("int32"), ctx=gpu, dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (B, P)).astype("float32"), ctx=gpu)
    mx.random.seed(0)
    net = bert_small(num_layers=layers, units=128, hidden_size=256,
                     vocab_size=vocab, max_length=S, dropout=0.0,
                     use_pooler=False, use_decoder=True)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    amp.init("float16")
    seen = []
    real = TA.flash_attention_bshd_fwd
    monkeypatch.setattr(TA, "flash_attention_bshd_fwd",
                        lambda q, *a, **k: seen.append(q.dtype)
                        or real(q, *a, **k))
    try:
        with mx.autograd.predict_mode():
            net(x, None, None, vl, mp)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-4})
        amp.init_trainer(trainer)
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        counts = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES, TL.LAUNCHES,
                  TL.BWD_LAUNCHES)
        with mx.autograd.record():
            _, logits = net(x, None, None, vl, mp)
            loss = ce(logits.reshape(-1, vocab), y.reshape(-1)).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        trainer.step(1, ignore_stale_grad=True)
        torch.cuda.synchronize()
    finally:
        amp.disable()
    after = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES, TL.LAUNCHES,
             TL.BWD_LAUNCHES)
    n_ln = 2 * layers + 2
    assert [a - b for a, b in zip(after, counts)] == [layers, layers, n_ln,
                                                      n_ln]
    assert set(seen) == {torch.float16}
    assert logits.dtype == onp.float16 and loss.dtype == onp.float32
    assert not trainer._amp_loss_scaler._has_overflow
    assert onp.isfinite(float(loss.asscalar()))
    for k, p in net._collect_params_with_prefix().items():
        w, g = p.data().astorch(), p.grad().astorch()
        assert w.dtype == g.dtype == torch.float32, k
        assert bool(torch.isfinite(g).all()), k
    for state in trainer._updater.states.values():
        assert all(s.astorch().dtype == torch.float32 for s in state)


@pytest.mark.cuda
def test_bert_small_train_step_on_cuda(monkeypatch):
    """On the card: one masked-LM Adam step of a small BERT through
    autograd.record, backward and gluon.Trainer, bf16, with the fused
    LayerNorm route: one (B, T, H, D) attention launch a layer and one
    LayerNorm launch per norm, forward and backward each; finite loss and gradients; bf16
    weights, gradients and Adam state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert_small
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    layers, vocab, B, S, P = 2, 97, 2, 128, 5
    rs = onp.random.RandomState(0)
    gpu = mx.gpu(0)
    x = mx.nd.array(rs.randint(0, vocab, (B, S)).astype("float32"), ctx=gpu)
    vl = mx.nd.array(onp.array([S, 70], "int32"), ctx=gpu, dtype="int32")
    mp = mx.nd.array(onp.sort(rs.choice(70, (B, P), replace=False), 1)
                     .astype("int32"), ctx=gpu, dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (B, P)).astype("float32"), ctx=gpu)
    mx.random.seed(0)
    net = bert_small(num_layers=layers, units=64, hidden_size=128,
                     vocab_size=vocab, max_length=S, dropout=0.0,
                     use_pooler=False, use_decoder=True)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    with mx.autograd.predict_mode():
        net(x, None, None, vl, mp)
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-4})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    counts = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES, TL.LAUNCHES,
              TL.BWD_LAUNCHES)
    with mx.autograd.record():
        _, logits = net(x, None, None, vl, mp)
        loss = ce(logits.reshape(-1, vocab), y.reshape(-1)).mean()
    loss.backward()
    trainer.step(1, ignore_stale_grad=True)
    torch.cuda.synchronize()
    after = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES, TL.LAUNCHES,
             TL.BWD_LAUNCHES)
    n_ln = 2 * layers + 2
    assert [a - b for a, b in zip(after, counts)] == [layers, layers, n_ln,
                                                      n_ln]
    assert onp.isfinite(float(loss.astype("float32").asscalar()))
    for k, p in net._collect_params_with_prefix().items():
        w, g = p.data().astorch(), p.grad().astorch()
        assert w.dtype == g.dtype == torch.bfloat16, k
        assert bool(torch.isfinite(g).all()), k
        assert bool(g.any()) == (k != "type_embed.weight"), k
    for state in trainer._updater.states.values():
        assert all(s.astorch().dtype == torch.bfloat16 for s in state)


@pytest.mark.cuda
def test_flash_attention_bshd_kernels_match_plain_on_cuda():
    """On the card: the (B, T, H, D) forward and backward kernels against
    their plain versions, on strided views (q, k and v as the column
    blocks of one (B, T, 3 H D) buffer, the backward writing into views of
    one such gradient) and on contiguous operands: the forward as the
    (B, H, T, D) kernel is held (f32 o within 2e-5, bf16 within 2e-2 of
    the largest |o|, lse within 1e-5), the backward within 1e-5 (f32) and
    1e-2 (bf16) of the largest |plain gradient|, the same bits twice,
    exact zeros past the valid lengths; at BERT's head layout scaled down,
    causal D 128, f32, D 80 (padded), Tk 65 and 129, kv_lens 0 and on a
    tile edge; counted as BSHD launches; misaligned strides refused; and
    the public op's Function against the same Function on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    for B, Tq, Tk, H, D, dtype, causal, lens, packed in [
            (4, 256, 256, 12, 64, bf, False, (256, 200, 130, 64), True),
            (1, 512, 512, 4, 128, bf, True, None, False),
            (2, 256, 256, 2, 128, torch.float32, False, (256, 100), True),
            (2, 200, 200, 3, 80, bf, False, (200, 64), False),
            (2, 100, 65, 3, 64, bf, False, (64, 0), False),
            (2, 130, 129, 3, 64, bf, True, (128, 129), False)]:
        if packed:
            buf = torch.randn((B, Tq, 3 * H * D), device=dev,
                              generator=g).to(dtype)
            q, k, v = TA._qkv_heads(buf, H)
        else:
            q, k, v = (torch.randn((B, T, H, D), device=dev, generator=g)
                       .to(dtype) for T in (Tq, Tk, Tk))
        do = torch.randn((B, Tq, H, D), device=dev, generator=g).to(dtype)
        kw = dict(causal=causal)
        if lens is not None:
            kw["kv_lens"] = torch.tensor(lens, device=dev, dtype=torch.int32)
        before = (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES)
        o, lse = TA.flash_attention_bshd_fwd(q, k, v, **kw)
        if packed:
            grad = torch.full_like(buf, float("nan"))
            got = TA.flash_attention_bshd_bwd(q, k, v, o, lse, do, **kw,
                                              out=TA._qkv_heads(grad, H))
        else:
            got = TA.flash_attention_bshd_bwd(q, k, v, o, lse, do, **kw)
        again = TA.flash_attention_bshd_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES) == \
            (before[0] + 1, before[1] + 2)
        want_o, want_lse = TA._flash_attention_bshd_plain(q, k, v, **kw)
        assert o.shape == want_o.shape and o.dtype == dtype
        assert (lse - want_lse).abs().max().item() <= 1e-5
        assert _bf16_close(o, want_o, 2e-5 if dtype == torch.float32
                           else 2e-2)
        want = TA._flash_attention_bshd_bwd_plain(q, k, v, o, lse, do, **kw)
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            assert a.dtype == dtype and a.shape == c.shape
            assert _bf16_close(a, c, rel)
        if packed:
            assert not torch.isnan(grad).any()
        for b, n in enumerate(lens or ()):
            assert not got[1][b, n:].any() and not got[2][b, n:].any()
    x = torch.zeros((1, 128, 2, 64), device=dev, dtype=bf)
    wide = torch.zeros((1, 128, 2 * 64 + 4), device=dev, dtype=bf)
    odd = wide[..., :128].unflatten(-1, (2, 64))     # a 264-byte row
    with pytest.raises(MXNetError, match="16-byte aligned strides"):
        TA.flash_attention_bshd_fwd(odd, x, x)
    qkv = [torch.randn((2, 128, 2, 32), device=dev, generator=g)
           .requires_grad_() for _ in range(3)]
    lens = torch.tensor([128, 40], device=dev)
    fwd, bwd = TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES
    TA.flash_attention_bshd(*qkv, causal=True, kv_lens=lens).square().sum() \
        .backward()
    assert (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in qkv]
    TA.flash_attention_bshd(*cpu, causal=True, kv_lens=lens.cpu()).square() \
        .sum().backward()
    for a, b in zip(qkv, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_backward_kernels_launch_from_a_fresh_thread():
    """A thread that has made no CUDA call yet (autograd runs a backward
    on a thread of its own) launches both backward entries, whose tensor
    maps need the device's context bound on the calling thread, and gets
    the main thread's bits; and the fused self-attention's backward
    through autograd, D 64, against the same on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn((2, 3, 128, 64), device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = TA.flash_attention_fwd(q, k, v)
    bq, bk, bv, bdo, bo = (t.transpose(1, 2) for t in (q, k, v, do, o))
    results = {}

    def run():
        try:
            results["bhtd"] = TA.flash_attention_bwd(q, k, v, o, lse, do)
            results["bshd"] = TA.flash_attention_bshd_bwd(
                bq, bk, bv, bo.contiguous(), lse, bdo.contiguous())
            torch.cuda.synchronize()
        except Exception as e:          # reported below, on the test's thread
            results["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in results, results.get("error")
    want = TA.flash_attention_bwd(q, k, v, o, lse, do)
    for a, b, c in zip(results["bhtd"], results["bshd"], want):
        assert torch.equal(a, c) and torch.equal(b.transpose(1, 2), c)
    qkv = torch.randn((2, 128, 3 * 128), device=dev, generator=g) \
        .requires_grad_()
    lens = torch.tensor([128, 50], device=dev, dtype=torch.int32)
    dout = torch.randn((2, 128, 128), device=dev, generator=g)
    got = torch.autograd.grad(TA.self_attention_bshd(qkv, 2, False, lens),
                              qkv, dout)[0]
    cpu = qkv.detach().cpu().requires_grad_()
    ref = torch.autograd.grad(TA.self_attention_bshd(cpu, 2, False,
                                                     lens.cpu()),
                              cpu, dout.cpu())[0]
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_forward_kernels_launch_from_a_fresh_thread():
    """A thread that has made no CUDA call yet launches both bf16 forward
    entries, whose tensor maps need the device's context bound on the
    calling thread, and gets the main thread's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((2, 3, 200, 64), device=dev, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([200, 70], device=dev, dtype=torch.int32)
    bq, bk, bv = (t.transpose(1, 2) for t in (q, k, v))
    results = {}

    def run():
        try:
            results["bhtd"] = TA.flash_attention_fwd(q, k, v, kv_lens=lens)
            results["bshd"] = TA.flash_attention_bshd_fwd(bq, bk, bv,
                                                          kv_lens=lens)
            torch.cuda.synchronize()
        except Exception as e:          # reported below, on the test's thread
            results["error"] = e
    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in results, results.get("error")
    o, lse = TA.flash_attention_fwd(q, k, v, kv_lens=lens)
    assert torch.equal(results["bhtd"][0], o)
    assert torch.equal(results["bhtd"][1], lse)
    assert torch.equal(results["bshd"][0].transpose(1, 2), o)
    assert torch.equal(results["bshd"][1], lse)


@pytest.mark.cuda
def test_nccl_one_rank_zero_step_gives_the_bits_of_no_mesh():
    """On the card: a DataParallelStep over a one-rank NCCL group with
    ``shard_optimizer=True`` (ZeRO's degenerate layout: reduce-scatter and
    all-gather over one rank) gives the bits of the same step without a
    mesh, weights and losses, over 3 Adam steps of a bf16 MLP."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    gpu = mx.gpu(0)
    rs = onp.random.RandomState(3)
    x = mx.nd.array(rs.randn(16, 12).astype("float32"), ctx=gpu) \
        .astype("bfloat16")
    y = mx.nd.array(rs.randint(0, 5, 16).astype("float32"), ctx=gpu)

    def net():
        mx.random.seed(4)
        n = mx.gluon.nn.HybridSequential(prefix="ncclmlp_")
        with n.name_scope():
            n.add(mx.gluon.nn.Dense(33, activation="relu", in_units=12),
                  mx.gluon.nn.Dense(5, in_units=33))
        n.initialize(mx.init.Xavier(), ctx=gpu)
        n.cast("bfloat16")
        return n

    def train(mesh, shard):
        n = net()
        ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        step = mx.parallel.DataParallelStep(
            n, lambda o, l: ce(o, l), mx.optimizer.Adam(learning_rate=0.01),
            mesh=mesh, shard_optimizer=shard)
        losses = [step(x, y).astorch() for _ in range(3)]
        return losses, [p.data().astorch().clone()
                        for _, p in sorted(n.collect_params().items())]
    want_losses, want = train(None, False)
    assert not dist.is_initialized()
    mx.parallel.initialize()
    try:
        mesh = mx.parallel.device_mesh()
        assert (mesh.size, mesh.backend) == (1, "nccl")
        losses, got = train(mesh, True)
    finally:
        dist.destroy_process_group()
    for a, b in zip(losses, want_losses):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.cuda
def test_lstm_and_gru_layers_on_cuda_match_cpu():
    """On the card: 2-layer LSTM and bidirectional GRU layers, float32
    with TF32 off, forward and backward (under ``record(train_mode=
    False)``, which records gradients outside training mode, so cuDNN's
    forward must still run in its training mode) against the same layers
    on the CPU (torch's native cells): outputs and states within rtol 1e-5,
    atol 1e-5, gradients within rtol 1e-3, atol 5e-5.  cuDNN sums the gate
    products and the steps' gradients in another order, and the gradients
    sum over every step of both directions: on an H100 the reverse
    direction's input weights of the bidirectional GRU came out of
    rtol 1e-4, atol 1e-5.  cuDNN runs bfloat16 too on an H100, within 4
    bf16 ulps of values in [0.5, 1) of float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import rnn as TR
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = onp.random.RandomState(0)
    x = rs.uniform(-1, 1, (4, 7, 24)).astype("float32")
    try:
        for kind in ("lstm", "gru"):
            runs = {}
            for ctx in (mx.cpu(), mx.gpu(0)):
                mx.random.seed(1)
                layer = (mx.gluon.rnn.LSTM(32, num_layers=2, layout="NTC")
                         if kind == "lstm" else
                         mx.gluon.rnn.GRU(32, num_layers=2, layout="NTC",
                                          bidirectional=True))
                with mx.cpu():
                    layer.initialize(mx.init.Xavier())
                    layer(mx.nd.array(x))
                layer.collect_params().reset_ctx(ctx)
                xs = mx.nd.array(x, ctx=ctx)
                xs.attach_grad()
                with mx.autograd.record(train_mode=False):
                    out, states = layer(xs, layer.begin_state(4, ctx=ctx))
                    loss = (out * out).sum() + sum(
                        (s * s).sum() for s in states)
                loss.backward()
                runs[ctx.device_type] = [out.asnumpy()] + [
                    s.asnumpy() for s in states] + [xs.grad.asnumpy()] + [
                    p.grad().asnumpy() for _, p in
                    sorted(layer._collect_params_with_prefix().items())]
                if ctx.device_type == "gpu":
                    assert TR.backend(xs.astorch()) == "cudnn"
                    layer.cast("bfloat16")
                    with mx.autograd.predict_mode():
                        half = layer(xs.astype("bfloat16"))
                    assert TR.backend(xs.astorch().bfloat16()) == "cudnn"
                    onp.testing.assert_allclose(
                        half.astype("float32").asnumpy(), runs["gpu"][0],
                        rtol=0, atol=4 * 2.0 ** -8)
            n_fwd = 3 if kind == "lstm" else 2
            for i, (g, c) in enumerate(zip(runs["gpu"], runs["cpu"])):
                fwd = i < n_fwd
                onp.testing.assert_allclose(
                    g, c, rtol=1e-5 if fwd else 1e-3,
                    atol=1e-5 if fwd else 5e-5,
                    err_msg="%s output %d" % (kind, i))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _small_bert_step_inputs(mx, vocab, B, S, P):
    import numpy as onp
    rs = onp.random.RandomState(0)
    gpu = mx.gpu(0)
    x = mx.nd.array(rs.randint(0, vocab, (B, S)).astype("float32"), ctx=gpu)
    vl = mx.nd.array(onp.array([S, 70], "int32"), ctx=gpu, dtype="int32")
    mp = mx.nd.array(onp.sort(rs.choice(70, (B, P), replace=False), 1)
                     .astype("int32"), ctx=gpu, dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (B, P)).astype("float32"), ctx=gpu)
    return (x, None, None, vl, mp), y


@pytest.mark.cuda
def test_captured_step_matches_eager_and_credits_launches(monkeypatch):
    """On the card: a small bf16 BERT through DataParallelStep (Adam, a
    rate halved every step), 4 calls through its CUDA graph (a warm-up
    and capture, then 3 replays) against 4 calls of the same body run
    eagerly from the same weights: the same bits, losses and weights; the
    attention and LayerNorm launches credited per replay, as many as the
    eager steps launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert_small
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    layers, vocab, B, S, P = 2, 97, 2, 128, 5
    data, y = _small_bert_step_inputs(mx, vocab, B, S, P)
    mx.random.seed(0)
    net = bert_small(num_layers=layers, units=64, hidden_size=128,
                     vocab_size=vocab, max_length=S, dropout=0.0,
                     use_pooler=False, use_decoder=True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(*data)
    net.cast("bfloat16")
    params = sorted(net.collect_params().items())
    w0 = [p.data().astorch().clone() for _, p in params]
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, lab):
        return ce(out[1].reshape(-1, vocab), lab.reshape(-1))

    def counts():
        return (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES, TL.LAUNCHES,
                TL.BWD_LAUNCHES)

    def run(eager):
        for (_, p), w in zip(params, w0):
            p.set_data(w)
        sched = mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        step = mx.parallel.DataParallelStep(
            net, loss, mx.optimizer.Adam(learning_rate=1e-3,
                                         lr_scheduler=sched), mesh=None)
        before = counts()
        call = step._run_eagerly if eager else step
        losses = [call(data, y).astorch() for _ in range(4)]
        torch.cuda.synchronize()
        after = counts()
        assert [e.graphed for e, _ in step._cache.values()] == [not eager]
        return losses, [p.data().astorch().clone() for _, p in params], \
            [a - b for a, b in zip(after, before)]
    g_losses, g_w, g_counts = run(False)
    e_losses, e_w, e_counts = run(True)
    n_ln = 2 * layers + 2
    assert g_counts == e_counts == [4 * layers, 4 * layers, 4 * n_ln,
                                    4 * n_ln]
    assert len({float(v.float()) for v in g_losses}) > 1
    for a, b in zip(g_losses, e_losses):
        assert torch.equal(a, b)
    for a, b in zip(g_w, e_w):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_captured_bucket_matches_eager_and_credits_launches(monkeypatch):
    """On the card: an AotModel of a LayerNorm net captured per bucket;
    a replay gives the bits of its body run eagerly and each replay is
    credited one LayerNorm launch; outputs are fresh tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serve import AotModel
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="cudagraph_ln_")
    with net.name_scope():
        net.add(nn.Dense(64, in_units=32), nn.LayerNorm(in_channels=64),
                nn.Dense(10, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    model = AotModel.from_block(net, (32,), name="cudagraph_ln")
    model.compile_all([1, 4])
    assert all(g.graphed for g in model._graphs.values())
    x = onp.random.RandomState(0).randn(4, 32).astype("float32")
    before = TL.LAUNCHES
    a, b = model.run(4, x), model.run(4, x)
    torch.cuda.synchronize()
    assert TL.LAUNCHES == before + 2
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    want = model._graphs[4].run_eager([torch.as_tensor(x)])[0]
    assert torch.equal(a, want)


@pytest.mark.cuda
def test_dropout_masks_advance_across_replays_and_restart_with_seed():
    """On the card: dropout inside a captured step (lr 0, so only the
    masks move the loss): each replay draws new masks, and after the same
    mx.random.seed the replays draw the same masks again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as onp
    import mxnet_tpu_torch as mx
    nn = mx.gluon.nn
    x = onp.random.RandomState(0).randn(8, 5).astype("float32")
    y = onp.random.RandomState(1).randn(8, 5).astype("float32")
    net = nn.HybridSequential(prefix="cudagraph_drop_")
    with net.name_scope():
        net.add(nn.Dense(64, in_units=5), nn.Dropout(0.5),
                nn.Dense(5, in_units=64))
    net.initialize(mx.init.One(), ctx=mx.gpu(0))
    L = mx.gluon.loss.L2Loss()
    step = mx.parallel.DataParallelStep(
        net, lambda o, l: L(o, l), mx.optimizer.SGD(learning_rate=0.0))
    mx.random.seed(3)
    first = [float(step(x, y).asnumpy()) for _ in range(4)]
    assert [e.graphed for e, _ in step._cache.values()] == [True]
    mx.random.seed(3)
    again = [float(step(x, y).asnumpy()) for _ in range(4)]
    assert len(set(first)) == 4
    # the first call warmed up eagerly: the replays after the seed repeat
    # the first call's masks and the replays' after it
    assert again == first


@pytest.mark.cuda
def test_device_scale_update_gives_the_bits_of_host_numbers_on_cuda():
    """On the card: an optimizer step given its per-step scale as a 0-d
    device tensor (what a captured step reads) gives the bits of the same
    step given ``t`` and ``lr`` as numbers: SGD without momentum (the fp32
    ``w + (-lr) g`` a fused multiply-add either way: ``addcmul`` against
    ``alpha=``), with momentum, and Adam; float32, bfloat16, and bfloat16
    with fp32 masters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.optimizer.optimizer import _f32, _leaves
    dev = torch.device("cuda", 0)
    g0 = torch.Generator(device=dev).manual_seed(5)
    for name, kw in (("sgd", dict(learning_rate=0.1, wd=1e-4,
                                  rescale_grad=0.5)),
                     ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                  wd=1e-4)),
                     ("adam", dict(learning_rate=1e-3, wd=1e-4,
                                   rescale_grad=0.5))):
        for mode in ("f32", "bf16", "bf16_mp"):
            o = mx.optimizer.create(name, multi_precision=mode == "bf16_mp",
                                    **kw)
            dtype = torch.float32 if mode == "f32" else torch.bfloat16
            w = torch.randn(1 << 20, device=dev, generator=g0).to(dtype)
            g = torch.randn(1 << 20, device=dev, generator=g0).to(dtype)
            state = _leaves(o.create_state_multi_precision(
                0, mx.nd.array(w, ctx=mx.gpu(0), dtype=w.dtype)))
            if mode == "bf16_mp":
                w, g, state = state[0], g.float(), state[1:]
            step = o.make_step(0)
            for t, lr in ((1, 0.1), (2, 0.05), (7, 0.0371)):
                want = step(w, g, t, lr, *state)
                scale = torch.tensor(o._fused_scale(_f32(lr), t, w.dtype),
                                     device=dev)
                got = step(w, g, None, None, *state, scale=scale)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b), \
                        (name, mode, t)
                w, state = want[0], list(want[1:])


def _chip_smoke():
    """``chip_smoke.py`` from the repo's root (its array sweep is shared
    with this file)."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.fixture
def tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.cuda
def test_array_surface_sweep_on_cuda(tf32_off):
    """``chip_smoke.array_sweep``: every op of ``ops/elemwise.py``,
    ``ops/matrix.py`` and ``ops/random_ops.py`` once on the card against
    the same call on the CPU (exact for integer, index, shape, comparison
    and ordering results, the stated tolerances for floats; the samplers'
    shape, dtype, device and support), the case table checked against the
    registry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    cs = _chip_smoke()
    r = cs.array_sweep(torch, mx, 0)
    assert r["covered"] == r["ops"] == len(cs.array_surface_ops(mx))
    assert r["ops"] >= 211


@pytest.mark.cuda
def test_hybridized_random_block_replays_new_draws_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    r = _chip_smoke().hybrid_random_replays(torch, mx, 3)
    assert r["replays"] == 8 and abs(r["mean"]) < 0.1


@pytest.mark.cuda
def test_samplers_draw_on_the_card_from_its_generator():
    """No ``ctx=``: the samplers draw on the card, from the card's
    generator, which ``mx.random.seed`` resets and ``generator_scope``
    replaces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    mx.random.seed(11)
    a = mx.nd.random.normal(shape=(1000,))
    assert a.context == mx.gpu(0) and a.astorch().is_cuda
    mx.random.seed(11)
    assert torch.equal(mx.nd.random.normal(shape=(1000,)).astorch(),
                       a.astorch())
    g = torch.Generator(device="cuda").manual_seed(11)
    with mx.random.generator_scope(g):
        b = mx.nd.random.normal(shape=(1000,))
    assert torch.equal(b.astorch(), torch.randn(
        1000, generator=torch.Generator(device="cuda").manual_seed(11),
        device="cuda"))


@pytest.mark.cuda
def test_array_ops_capture_in_a_hybridized_block_on_cuda():
    """Ops that make small tensors (``shape_array``, ``size_array``,
    ``_ravel_multi_index``, ``histogram`` with a range) and the samplers
    copy nothing from the host and read nothing back, so a hybridized
    block's CUDA graph captures them: the graph gives the eager block's
    bits, and its draws change from call to call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx

    class Block(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            sizes = F.shape_array(x).astype("float32").sum() \
                + F.size_array(x).astype("float32").sum()
            counts, edges = F.histogram(x, bin_cnt=5, range=(-1.0, 1.0))
            flat = F._ravel_multi_index(F.abs(x[:2, :3]).floor(),
                                        shape=(4, 5))
            hot = F.one_hot(F.topk(x, k=2), depth=x.shape[-1]).sum(axis=1)
            draws = F.random.gamma(2.0, shape=(3,), ctx=x.context)
            return sizes, counts, edges, flat, hot, draws

    x = mx.nd.array(torch.randn(4, 6, generator=torch.Generator()
                                .manual_seed(0)) * 2, ctx=mx.gpu(0))
    eager = Block()(x)
    net = Block()
    net.hybridize()
    runs = [net(x) for _ in range(3)]
    assert net._cached_graph is not None
    for out in runs:
        for got, want in zip(out[:5], eager[:5]):
            assert torch.equal(got.astorch(), want.astorch())
    assert not torch.equal(runs[1][5].astorch(), runs[2][5].astorch())


def _ulps16(a, b):
    """The largest distance in ulps between two 16-bit float tensors of
    one sign pattern (their bits read as integers)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()) \
        .abs().max().item()


@pytest.mark.cuda
def test_float16_epilogue_kernels_match_plain_on_cuda():
    """The float16 instantiations of the epilogue kernels: forward and
    backward within 1 ulp of the plain version (the same fp32 value
    rounded once), dscale/dshift within rel 1e-5, the backward twice to
    the same bits; NCHW, NHWC, a ragged and an unaligned case, each a
    launch; values past 65504 become inf, as astype gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(13)
    for shape, axis, off in [((4, 64, 7, 7), 1, 0), ((3, 5, 5, 40), 3, 0),
                             ((2, 3, 37), 1, 0), ((2, 64, 7, 7), 1, 1)]:
        n = 1
        for d in shape:
            n *= d
        c = shape[axis]

        def rand():
            v = torch.randn(n + off, device=dev, generator=g) * 4
            return v.half()[off:].view(shape)
        x, r, ct = rand(), rand(), rand()
        s = torch.rand(c, device=dev, generator=g) + 0.5
        t = torch.randn(c, device=dev, generator=g)
        fwd, bwd = TFN.LAUNCHES, TFN.BWD_LAUNCHES
        y = TFN.fused_bn_add_relu_epilogue(x, s, t, r, axis)
        got = TFN.fused_bn_add_relu_epilogue_bwd(x, s, y, ct, axis)
        again = TFN.fused_bn_add_relu_epilogue_bwd(x, s, y, ct, axis)
        torch.cuda.synchronize()
        assert (TFN.LAUNCHES, TFN.BWD_LAUNCHES) == (fwd + 1, bwd + 2)
        assert y.dtype == torch.float16
        assert _ulps16(y, TFN.fused_bn_add_relu_epilogue_plain(
            x, s, t, r, axis)) <= 1
        want = TFN.fused_bn_add_relu_epilogue_bwd_plain(x, s, y, ct, axis)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == torch.float16 and _ulps16(a, b) <= 1
        for a, b in zip(got[2:], want[2:]):
            assert a.dtype == torch.float32
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    x = torch.full((2, 8, 3, 3), 40000.0, device=dev).half()
    y = TFN.fused_bn_add_relu_epilogue(x, torch.full((8,), 2.0, device=dev),
                                       torch.zeros(8, device=dev), x, 1)
    assert torch.isinf(y).all()


@pytest.mark.cuda
def test_float16_layernorm_kernels_match_plain_on_cuda():
    """The LayerNorm kernels for every pair of x and gamma/beta dtypes
    with float16 in it: y in their promotion and within 1e-5 plus one ulp
    of its dtype of the plain version, dx in x's dtype likewise, dgamma
    and dbeta fp32 within rel 1e-5, the backward twice to the same bits;
    one row, a row past a block of eight, C 768 (16-byte loads), C 1001
    (one element a load) and C 2048 (the shared-memory sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(14)
    mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}

    def tol(a, b):
        _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
        return 1e-5 + torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                                  e - 1 - mant[a.dtype])
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    for (N, C), xd, gd in [((9, 768), f16, f16), ((1, 768), f16, f32),
                           ((1057, 768), f16, f16), ((64, 1001), f16, f16),
                           ((33, 2048), f16, f16), ((9, 768), f32, f16),
                           ((9, 768), bf16, f16), ((9, 768), f16, bf16)]:
        x = (torch.randn((N, C), device=dev, generator=g) * 2 + 0.5).to(xd)
        ga = (torch.rand(C, device=dev, generator=g) + 0.5).to(gd)
        be = (torch.rand(C, device=dev, generator=g) - 0.5).to(gd)
        fwd, bwd = TL.LAUNCHES, TL.BWD_LAUNCHES
        y, mu, rstd = TL.layer_norm_fwd(x, ga, be, 1e-5)
        py, _, _ = TL._layer_norm_fwd_plain(x, ga, be, 1e-5)
        assert y.dtype == py.dtype == torch.promote_types(xd, gd)
        assert ((y.float() - py.float()).abs() <= tol(y, py)).all()
        ct = torch.randn((N, C), device=dev, generator=g).to(y.dtype)
        got = TL.layer_norm_bwd(x, ga, mu, rstd, ct)
        again = TL.layer_norm_bwd(x, ga, mu, rstd, ct)
        torch.cuda.synchronize()
        assert (TL.LAUNCHES, TL.BWD_LAUNCHES) == (fwd + 1, bwd + 2)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = TL._layer_norm_bwd_plain(x, ga, mu, rstd, ct)
        assert [a.dtype for a in got] == [xd, f32, f32]
        assert ((got[0].float() - want[0].float()).abs()
                <= tol(got[0], want[0])).all()
        for a, b in zip(got[1:], want[1:]):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_float16_narrow_resnet_on_cuda_matches_cpu(tf32_off):
    """``chip_smoke.f16_resnet_card_vs_cpu``: a narrow ResNetV1 cast to
    float16 (BatchNorm float32) on the card against the CPU from the same
    weights, its eval logits and two SGD steps with multi_precision held
    to chip_smoke's tolerances, through both float16 epilogue kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mxnet_tpu_torch as mx
    cs = _chip_smoke()
    fwd, bwd = TFN.LAUNCHES, TFN.BWD_LAUNCHES
    r = cs.f16_resnet_card_vs_cpu(torch, mx, 15)
    assert TFN.LAUNCHES > fwd and TFN.BWD_LAUNCHES > bwd
    assert r["logit_rel"] <= cs.F16_LOGIT_REL
    assert r["loss_rel"] <= cs.F16_LOSS_RTOL
    assert all(err <= cs.F16_SGD_LEAF_REL for _, err in r["worst_leaf"])


@pytest.mark.cuda
def test_public_attention_backward_at_a_padded_head_dim_on_cuda():
    """``flash_attention`` under autograd at D 80 (the kernels pad it to
    128): the backward takes the forward's o, a view of its padded
    output, and launches; dq, dk and dv within 1e-2 of the largest |plain
    gradient| (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v = ((torch.rand((2, 3, 256, 80), device=dev, generator=g) * 2
                - 1).to(torch.bfloat16).requires_grad_() for _ in range(3))
    ct = torch.randn((2, 3, 256, 80), device=dev, generator=g) \
        .to(torch.bfloat16)
    before = (TA.LAUNCHES, TA.BWD_LAUNCHES)
    got = torch.autograd.grad(TA.flash_attention(q, k, v), (q, k, v), ct)
    torch.cuda.synchronize()
    assert (TA.LAUNCHES, TA.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o, _ = TA._flash_attention_plain(qf, kf, vf)
    want = torch.autograd.grad(o, (qf, kf, vf), ct.float())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = (a.float() - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item()


def _f32_attention_check(entry, q, k, v, do, kw, what, out=None):
    """One float32 case through one entry on the card against the plain
    versions: o within 2e-5 and lse within 1e-5 absolute; dq, dk and dv
    within 1e-5 of the largest |plain value| (with one key a row, dq and
    dk, 0 in exact arithmetic, within 1e-5 of the largest |dv|); the
    backward twice to the same bits; exact zeros in dk and dv past each
    row's valid length; one launch of the entry a call."""
    if entry == "bhtd":
        fwd, bwd = TA.flash_attention_fwd, TA.flash_attention_bwd
        pf, pb = TA._flash_attention_plain, TA._flash_attention_bwd_plain
        counts = lambda: (TA.LAUNCHES, TA.BWD_LAUNCHES)
        key_axis = 2
    else:
        fwd, bwd = TA.flash_attention_bshd_fwd, TA.flash_attention_bshd_bwd
        pf, pb = TA._flash_attention_bshd_plain, \
            TA._flash_attention_bshd_bwd_plain
        counts = lambda: (TA.BSHD_LAUNCHES, TA.BSHD_BWD_LAUNCHES)
        key_axis = 1
        if out is not None:
            kw = dict(kw, out=out)
    before = counts()
    o, lse = fwd(q, k, v, **{a: b for a, b in kw.items() if a != "out"})
    got = [t.clone() for t in bwd(q, k, v, o, lse, do, **kw)]
    again = bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 2), what
    plain_kw = {a: b for a, b in kw.items() if a != "out"}
    want_o, want_lse = pf(q, k, v, **plain_kw)
    assert o.dtype == torch.float32 and o.shape == want_o.shape, what
    assert (o - want_o).abs().max().item() <= 2e-5, what
    assert (lse - want_lse).abs().max().item() <= 1e-5, what
    want = pb(q, k, v, o, lse, do, **plain_kw)
    one_key = k.shape[key_axis] == 1
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), (what, name)
        ref = want[2] if one_key and name != "dv" else w
        e = (a - w).abs().max().item()
        assert e <= 1e-5 * ref.abs().max().item(), (what, name, e)
    lens = kw.get("kv_lens")
    for b, n in enumerate([] if lens is None else lens.tolist()):
        for t in got[1:]:
            rows = t[b, :, n:] if entry == "bhtd" else t[b, n:]
            assert not rows.any(), (what, "keys past the valid length")


@pytest.mark.cuda
def test_float32_attention_on_bert_views_on_cuda(tf32_off):
    """BERT-base's float32 layer on the three-TF32 kernels: q, k and v as
    (B, T, H, D) views of one (24, 512, 3 x 768) projection output,
    ``bench.py``'s valid lengths, the gradients written into views of one
    such tensor; against the plain versions (``_f32_attention_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(21)
    _, lens, _ = cs.bert_inputs(0)
    buf = torch.randn((24, 512, 3 * 768), device=dev, generator=g)
    q, k, v = TA._qkv_heads(buf, 12)
    do = torch.randn((24, 512, 12, 64), device=dev, generator=g)
    grad = torch.empty_like(buf)
    _f32_attention_check("bshd", q, k, v, do,
                         {"kv_lens": torch.tensor(lens, device=dev)},
                         "f32 BERT views", out=TA._qkv_heads(grad, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_float32_attention_head_dims_and_masks_on_cuda(tf32_off, D):
    """The three-TF32 kernels at each head dim they are built for, with
    causal and kv_lens masks over a ragged Tq != Tk, and with segment ids
    and a row of valid length 0, through both entries (segments through
    the (B, H, T, D) one), against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(D)
    for B, H, Tq, Tk, causal, lens, seg in (
            (2, 2, 130, 129, True, (129, 60), False),
            (2, 2, 100, 100, False, (0, 100), True)):
        q, k, v, do = (torch.randn((B, H, T, D), device=dev, generator=g)
                       for T in (Tq, Tk, Tk, Tq))
        kw = {"causal": causal, "kv_lens": torch.tensor(lens, device=dev)}
        if seg:
            kw["q_segments"] = torch.randint(0, 3, (B, Tq), device=dev,
                                             generator=g).sort(1).values
            kw["kv_segments"] = torch.randint(0, 3, (B, Tk), device=dev,
                                              generator=g).sort(1).values
        what = (B, H, Tq, Tk, D, causal, lens, seg)
        _f32_attention_check("bhtd", q, k, v, do, kw, what)
        if not seg:
            _f32_attention_check(
                "bshd", *(t.transpose(1, 2).contiguous()
                          for t in (q, k, v, do)), kw, what)


@pytest.mark.cuda
@pytest.mark.parametrize("Tk", [1, 63, 65, 129])
def test_float32_attention_tile_edges_on_cuda(tf32_off, Tk):
    """The three-TF32 kernels at the edges of their tiles: Tk of 1, 63, 65
    and 129 keys (fewer keys than a tile, one past a tile, a ragged last
    tile), a valid length on a tile edge or 0, at D 64 and 128, through
    both entries, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(Tk)
    lens = (Tk, Tk // 2 // 16 * 16 if Tk > 32 else 0)
    for D in (64, 128):
        q, k, v, do = (torch.randn((2, 3, T, D), device=dev, generator=g)
                       for T in (100, Tk, Tk, 100))
        kw = {"kv_lens": torch.tensor(lens, device=dev)}
        what = (100, Tk, D, lens)
        _f32_attention_check("bhtd", q, k, v, do, kw, what)
        _f32_attention_check("bshd", *(t.transpose(1, 2).contiguous()
                                       for t in (q, k, v, do)), kw, what)


def _card_against_cpu(name, inputs, kw, diff, rtol=1e-4):
    """The registered op ``name`` on card copies of ``inputs`` against the
    same op on the CPU: every output and the gradients of the inputs at
    ``diff`` (of a seeded cotangent) within ``rtol`` of the CPU's largest
    magnitude."""
    from mxnet_tpu_torch.ops.registry import get_op
    fn = get_op(name).fn
    runs = []
    for dev in ("cpu", "cuda"):
        ins = [t.to(dev).requires_grad_(i in diff)
               for i, t in enumerate(inputs)]
        out = fn(*ins, **kw)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        g = torch.Generator().manual_seed(5)
        cts = [torch.randn(o.shape, generator=g).to(dev) for o in outs]
        grads = torch.autograd.grad(outs, [ins[i] for i in diff], cts) \
            if diff else []
        runs.append([t.detach().cpu() for t in outs + list(grads)])
    for got, want in zip(runs[1], runs[0]):
        assert got.shape == want.shape and got.dtype == want.dtype
        if not want.is_floating_point():
            assert torch.equal(got, want)
            continue
        # a window wholly in the padding pools to -inf on both
        finite = torch.isfinite(want)
        assert torch.equal(got[~finite], want[~finite]), (name, kw)
        got, want = got[finite].double(), want[finite].double()
        err = (got - want).abs().max().item()
        assert err <= rtol * want.abs().max().item(), (name, kw, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg"),
    dict(kernel=(2, 2), stride=(2, 2), pad=(2, 2), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="lp", p_value=2)],
    ids=["max_full", "avg_full_exclude_pad", "avg_include_pad",
         "max_pad_above_half", "sum", "lp"])
def test_pooling_conventions_on_cuda_match_cpu(tf32_off, kw):
    """The pooling conventions the JAX op takes (explicit padding, the
    ceil windows of ``full``, pads above half the kernel), on the card
    against the CPU, forward and backward; and integer max pooling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.rand((4, 16, 17, 17), generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    _card_against_cpu("Pooling", [x], kw, (0,))
    xi = torch.randint(-100, 100, (2, 8, 9, 9), dtype=torch.int32,
                       generator=torch.Generator().manual_seed(2))
    if kw["pool_type"] == "max":
        _card_against_cpu("Pooling", [xi], kw, ())


@pytest.mark.cuda
@pytest.mark.parametrize("adj", [(1, 1), (2, 2), (3, 1)])
def test_deconvolution_adj_on_cuda_matches_cpu(tf32_off, adj):
    """``Deconvolution`` with ``adj`` below the stride (one
    ``conv_transpose``) and at or above it (the composed dilation, pad
    and flipped weight), grouped, on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 9, 9), generator=g)
    w = torch.randn((8, 3, 3, 3), generator=g) * 0.2
    b = torch.randn((6,), generator=g)
    _card_against_cpu("Deconvolution", [x, w, b],
                      dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           adj=adj, num_filter=6, num_group=2,
                           no_bias=False), (0, 1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_softmax_output_backward_on_cuda_matches_cpu(normalization):
    """``SoftmaxOutput``'s own backward, ``(p - target)`` scaled, with
    ``ignore_label`` and label smoothing, on the card against the CPU,
    the head gradient ignored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((128, 1000), generator=g) * 3
    lab = torch.randint(0, 1000, (128,), generator=g).float()
    lab[::4] = -1.0
    for smooth in (0.0, 0.1):
        _card_against_cpu("SoftmaxOutput", [x, lab],
                          dict(use_ignore=True, ignore_label=-1.0,
                               normalization=normalization,
                               smooth_alpha=smooth, grad_scale=2.0), (0,))
