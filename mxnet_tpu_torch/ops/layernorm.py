"""Fused LayerNorm over the last axis: the kernel's wrapper, its plain
PyTorch version and the route the ``LayerNorm`` op takes when
``MXNET_FUSED_LAYERNORM=1``.

Counterpart of ``mxnet_tpu/ops/pallas_layernorm.py``.  Per row of ``x``
(N, C):

    mu = mean(x);  var = mean((x - mu)²);  rstd = rsqrt(var + eps)
    y = (x - mu) * rstd * gamma + beta

in fp32 with ``y`` cast once to the promotion of (x, gamma, beta), and
``mu``/``rstd`` returned as (N, 1) fp32.  The backward, from the
cotangent ``ct`` of y:

    xhat = (x - mu) * rstd;  ctg = ct * gamma
    dx = (ctg - mean(ctg) - xhat * mean(ctg * xhat)) * rstd   (x's dtype)
    dgamma = sum over rows of ct * xhat;  dbeta = sum of ct   (fp32)

:func:`layer_norm_fwd` and :func:`layer_norm_bwd` launch the hand-written
kernels of ``csrc/layernorm.cu`` for CUDA tensors (f32, bf16 or f16 x,
gamma and beta of one of those dtypes) or raise, and run their plain versions
for CPU tensors.  :func:`fused_layer_norm` pairs the two as one
``torch.autograd.Function``, whose backward casts dgamma and dbeta to the
dtypes of gamma and beta, as the JAX package's ``_fln_bwd`` does.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_bwd",
           "LAUNCHES", "BWD_LAUNCHES"]

# kernel launches in this process, forward and backward
LAUNCHES = 0
BWD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the largest C the kernel takes: one warp holds a row in its registers,
# 64 values a lane (csrc/layernorm.cu, mx_layer_norm_max_channels)
MAX_CHANNELS = 2048
_FNS = {}


def _kernel_fn(name="fwd"):
    if not _FNS:
        from .. import kernels
        lib = kernels.load("layernorm")
        fn = lib.mx_layer_norm_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.mx_layer_norm_bwd
        bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        blocks = lib.mx_layer_norm_bwd_blocks
        blocks.argtypes = [ctypes.c_longlong]
        blocks.restype = ctypes.c_longlong
        limit = lib.mx_layer_norm_max_channels
        limit.restype = ctypes.c_int
        if limit() != MAX_CHANNELS:
            raise MXNetError("layernorm kernel takes C <= %d, the wrapper "
                             "assumes %d" % (limit(), MAX_CHANNELS))
        _FNS.update(fwd=fn, bwd=bwd, bwd_blocks=blocks)
    return _FNS[name]


def _out_dtype(x, gamma, beta):
    return torch.promote_types(torch.promote_types(x.dtype, gamma.dtype),
                               beta.dtype)


def _layer_norm_fwd_plain(x2d, gamma, beta, eps):
    """The plain PyTorch forward, in the kernel's order of operations:
    fp32 statistics (float64 for float64 inputs), two-pass variance,
    ``y`` rounded once.  Returns ``(y, mu (N, 1), rstd (N, 1))``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    x = x2d.to(cdt)
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.to(cdt) + beta.to(cdt)
    return y.to(_out_dtype(x2d, gamma, beta)), mu, rstd


def _layer_norm_bwd_plain(x2d, gamma, mu, rstd, ct2d):
    """The plain PyTorch backward, in the order of operations of the TPU
    kernel ``_ln_bwd_kernel``: fp32 (float64 for float64 inputs) x-hat,
    ``ct * gamma`` and its two row means, ``dx`` rounded once to x's
    dtype, ``dgamma``/``dbeta`` summed over the rows in fp32.  Returns
    ``(dx, dgamma, dbeta)``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    ct = ct2d.to(cdt)
    xhat = (x2d.to(cdt) - mu) * rstd
    ctg = ct * gamma.to(cdt)
    m1 = ctg.mean(dim=-1, keepdim=True)
    m2 = (ctg * xhat).mean(dim=-1, keepdim=True)
    dx = ((ctg - m1 - xhat * m2) * rstd).to(x2d.dtype)
    return dx, (ct * xhat).sum(dim=0), ct.sum(dim=0)


def _count(backward=False):
    global LAUNCHES, BWD_LAUNCHES
    with _COUNT_LOCK:
        if backward:
            BWD_LAUNCHES += 1
        else:
            LAUNCHES += 1


def layer_norm_fwd(x2d, gamma, beta, eps):
    """``(y, mu, rstd)`` of a LayerNorm over the rows of ``x2d`` (N, C):
    y (N, C) in the promotion of the three dtypes, mu and rstd (N, 1)
    fp32.  Launches the CUDA kernel for CUDA tensors and runs the plain
    version for CPU tensors."""
    if x2d.dim() != 2 or gamma.shape != (x2d.shape[1],) \
            or beta.shape != gamma.shape:
        raise ValueError("layer_norm_fwd: x (N, C) with gamma and beta (C,), "
                         "got %s, %s, %s" % (tuple(x2d.shape),
                                             tuple(gamma.shape),
                                             tuple(beta.shape)))
    devices = {t.device for t in (x2d, gamma, beta)}
    if len(devices) != 1:
        raise MXNetError("layer_norm_fwd: operands on several devices %s"
                         % sorted(map(str, devices)))
    device = devices.pop()
    if device.type == "cpu":
        return _layer_norm_fwd_plain(x2d, gamma, beta, eps)
    if device.type == "meta":
        # the shape rule of shape inference (Symbol.infer_shape): outputs
        # without data; a CUDA tensor never takes it
        N, C = x2d.shape
        return (torch.empty((N, C), dtype=_out_dtype(x2d, gamma, beta),
                            device=device),
                torch.empty((N, 1), dtype=torch.float32, device=device),
                torch.empty((N, 1), dtype=torch.float32, device=device))
    if device.type != "cuda":
        raise MXNetError("layer_norm_fwd: no kernel for device %s" % device)
    x_code = _DTYPE_CODE.get(x2d.dtype)
    g_code = _DTYPE_CODE.get(gamma.dtype)
    if x_code is None or g_code is None or beta.dtype != gamma.dtype:
        raise MXNetError("layer_norm_fwd: the CUDA kernel takes float32, "
                         "bfloat16 or float16 x and gamma and beta of one "
                         "such dtype, "
                         "got %s, %s, %s" % (x2d.dtype, gamma.dtype,
                                             beta.dtype))
    if not (x2d.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise MXNetError("layer_norm_fwd: the CUDA kernel takes contiguous "
                         "operands")
    N, C = x2d.shape
    if C > MAX_CHANNELS:
        raise MXNetError("layer_norm_fwd: the CUDA kernel takes C <= %d, got "
                         "%d" % (MAX_CHANNELS, C))
    y = torch.empty((N, C), dtype=_out_dtype(x2d, gamma, beta),
                    device=device)
    mu = torch.empty((N, 1), dtype=torch.float32, device=device)
    rstd = torch.empty((N, 1), dtype=torch.float32, device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N, C,
                float(eps), x_code, g_code, stream)
    if rc != 0:
        raise MXNetError("layer_norm_fwd: kernel launch failed with CUDA "
                         "error %d" % rc)
    _count()
    return y, mu, rstd


def layer_norm_bwd(x2d, gamma, mu, rstd, ct2d):
    """``(dx, dgamma, dbeta)`` of :func:`layer_norm_fwd` from the cotangent
    ``ct2d`` of y: dx (N, C) in x's dtype, dgamma and dbeta (C,) fp32.
    Launches the CUDA kernel for CUDA tensors and runs the plain version
    for CPU tensors.  The kernel takes the forward's operand dtypes, ``ct2d``
    in y's dtype and contiguous operands, and raises on anything else."""
    N, C = x2d.shape if x2d.dim() == 2 else (None, None)
    if N is None or gamma.shape != (C,) or ct2d.shape != x2d.shape \
            or mu.shape != (N, 1) or rstd.shape != (N, 1):
        raise ValueError("layer_norm_bwd: x and ct (N, C), gamma (C,), mu "
                         "and rstd (N, 1), got %s, %s, %s, %s, %s"
                         % tuple(tuple(t.shape) for t in (x2d, ct2d, gamma,
                                                          mu, rstd)))
    devices = {t.device for t in (x2d, gamma, mu, rstd, ct2d)}
    if len(devices) != 1:
        raise MXNetError("layer_norm_bwd: operands on several devices %s"
                         % sorted(map(str, devices)))
    device = devices.pop()
    if device.type == "cpu":
        return _layer_norm_bwd_plain(x2d, gamma, mu, rstd, ct2d)
    if device.type != "cuda":
        raise MXNetError("layer_norm_bwd: no kernel for device %s" % device)
    x_code = _DTYPE_CODE.get(x2d.dtype)
    g_code = _DTYPE_CODE.get(gamma.dtype)
    if x_code is None or g_code is None \
            or ct2d.dtype != torch.promote_types(x2d.dtype, gamma.dtype) \
            or mu.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise MXNetError("layer_norm_bwd: the CUDA kernel takes float32, "
                         "bfloat16 or float16 x and gamma, ct in their "
                         "promotion and "
                         "float32 mu and rstd, got %s, %s, %s, %s, %s"
                         % (x2d.dtype, gamma.dtype, ct2d.dtype, mu.dtype,
                            rstd.dtype))
    if not all(t.is_contiguous() for t in (x2d, gamma, mu, rstd, ct2d)):
        raise MXNetError("layer_norm_bwd: the CUDA kernel takes contiguous "
                         "operands")
    if C > MAX_CHANNELS:
        raise MXNetError("layer_norm_bwd: the CUDA kernel takes C <= %d, got "
                         "%d" % (MAX_CHANNELS, C))
    fn = _kernel_fn("bwd")
    blocks = _kernel_fn("bwd_blocks")(N)
    dx = torch.empty_like(x2d)
    ws = torch.empty((blocks, 2, C), dtype=torch.float32, device=device)
    dg = torch.empty(C, dtype=torch.float32, device=device)
    db = torch.empty(C, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x2d.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
                rstd.data_ptr(), ct2d.data_ptr(), dx.data_ptr(),
                ws.data_ptr(), dg.data_ptr(), db.data_ptr(), N, C, x_code,
                g_code, stream)
    if rc != 0:
        raise MXNetError("layer_norm_bwd: kernel launch failed with CUDA "
                         "error %d" % rc)
    _count(backward=True)
    return dx, dg, db


class _LayerNormFunction(torch.autograd.Function):
    """The fused LayerNorm over the rows of a contiguous (N, C) ``x``:
    forward :func:`layer_norm_fwd`, which saves x, gamma, mu and rstd;
    backward :func:`layer_norm_bwd`, its dgamma and dbeta cast to the
    dtypes of gamma and beta."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps):
        y, mu, rstd = layer_norm_fwd(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mu, rstd)
        ctx.beta_dtype = beta.dtype
        return y

    @staticmethod
    def backward(ctx, ct):
        x2d, gamma, mu, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2d, gamma, mu, rstd, ct.contiguous())
        return dx, dg.to(gamma.dtype), db.to(ctx.beta_dtype), None


def _pick_block_rows(C):
    """Rows a block of the kernel normalises (one warp each), or None
    where C is past the kernel's limit and the composed LayerNorm takes
    the rows instead: the card's counterpart of the JAX package's VMEM
    row-block picker."""
    return 4 if C <= MAX_CHANNELS else None


def _composed_ln(data, gamma, beta, eps):
    """The JAX package's composed form of the fused op (``_jnp_ln``):
    fp32 two-pass statistics, normalised values cast to the data dtype,
    then the affine in the promoted dtype."""
    x32 = data.to(torch.promote_types(data.dtype, torch.float32))
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = (xc * torch.rsqrt(var + eps)).to(data.dtype)
    return out * gamma + beta


def fused_layer_norm(data, gamma, beta, eps=1e-5):
    """Last-axis LayerNorm through the kernels (the composed form for C
    past the kernel's limit), differentiable through the backward kernel
    where a gradient is recorded.  The output dtype is the promotion of
    (data, gamma, beta), as the composed form's."""
    C = data.shape[-1]
    if _pick_block_rows(C) is None:
        return _composed_ln(data, gamma, beta, eps)
    y = _LayerNormFunction.apply(data.reshape(-1, C).contiguous(), gamma,
                                 beta, eps)
    return y.reshape(data.shape)
