"""Neural-network operators on torch tensors.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the ops the ResNet v1 and BERT
paths use: ``FullyConnected``, ``Convolution``, ``Pooling``,
``Activation``, ``BatchNorm``, ``_contrib_BatchNormAddRelu``,
``LayerNorm``, ``LeakyReLU``, ``softmax``, ``Dropout``, ``Embedding`` and
``SequenceLast`` (the recurrent cells' ``unroll``), plus ``Flatten`` (``mxnet_tpu/ops/matrix.py`` there).  Convolutions and dense
layers are ``torch.nn.functional`` calls (cuDNN and cuBLAS on the card,
as XLA's own lowering was on the TPU).  The BatchNorm ops reproduce the
JAX package's numerics exactly: one-pass fp32 batch statistics, and the
per-op difference in where the folded scale/shift are rounded (see
:func:`batch_norm` and :func:`batch_norm_add_relu`).  The residual
epilogue runs through the hand-written kernels in ``ops/fused_norm.py``,
forward and backward; LayerNorm takes the kernel of ``ops/layernorm.py``
when ``MXNET_FUSED_LAYERNORM=1``, as the JAX package takes its Pallas
kernel.  Every op is differentiable through torch's autograd.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .. import random as _random
from .fused_norm import fused_bn_add_relu_epilogue
from .layernorm import fused_layer_norm
from .registry import register

__all__ = ["fully_connected", "convolution", "pooling", "activation",
           "flatten", "batch_norm", "batch_norm_add_relu", "layer_norm",
           "leaky_relu", "softmax", "dropout", "embedding", "sequence_last",
           "cross_rank_batch_stats"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden: int = 0,
                    no_bias: bool = False, flatten: bool = True):
    """y = x·Wᵀ + b, flattening all but the batch axis when ``flatten``.
    Operands of several dtypes meet in their promotion, as ``jnp.matmul``
    and the bias add promote in the JAX op (float32 attention output
    against float16 weights gives float32)."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 else data
    bias = None if no_bias else bias
    if x.dtype == weight.dtype and (bias is None or bias.dtype == x.dtype):
        return F.linear(x, weight, bias)
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias


@register("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=(), stride=None, dilate=None,
                pad=None, num_filter: int = 0, num_group: int = 1,
                no_bias: bool = False, cudnn_tune=None, cudnn_off: bool = False,
                workspace: int = 1024, layout=None):
    """N-D convolution in NC(D)HW layout with an OI(D)HW weight."""
    n = len(kernel) if kernel else data.dim() - 2
    if layout not in (None, "NCW", "NCHW", "NCDHW"):
        raise MXNetError("Convolution: layout %r is not ported" % (layout,))
    pads = _tup(pad, n) if pad is not None else (0,) * n
    return _CONV[n](data, weight, None if no_bias else bias,
                    stride=_tup(stride, n), padding=pads,
                    dilation=_tup(dilate, n), groups=num_group)


@register("Pooling", aliases=("pooling",))
def pooling(data, kernel=(), pool_type: str = "max", global_pool: bool = False,
            stride=None, pad=None, pooling_convention: str = "valid",
            cudnn_off: bool = False, p_value=None, count_include_pad=None,
            layout=None):
    """Max pooling with the ``valid`` convention (padding with -inf, as
    the JAX op does), or global max or average pooling."""
    n = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=dims, keepdim=True)
        if pool_type == "avg":
            return torch.mean(data, dim=dims, keepdim=True)
        raise MXNetError("Pooling: global %r pooling is not ported" % pool_type)
    if pooling_convention != "valid":
        raise MXNetError("Pooling: convention %r is not ported"
                         % pooling_convention)
    k = _tup(kernel, n)
    s = _tup(stride, n) if stride is not None else k
    p = _tup(pad, n) if pad is not None else (0,) * n
    if any(2 * pp > kk for pp, kk in zip(p, k)):
        raise MXNetError("Pooling: pad %r exceeds half the kernel %r" % (p, k))
    if pool_type != "max":
        raise MXNetError("Pooling: pool_type %r is not ported" % pool_type)
    return _MAX_POOL[n](data, k, s, p)


@register("Activation", aliases=("activation",))
def activation(data, act_type: str = "relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise ValueError("unknown act_type %r" % act_type)


@register("Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


class _StatsGroup(threading.local):
    def __init__(self):
        self.group, self.size = None, 1


_STATS = _StatsGroup()


@contextlib.contextmanager
def cross_rank_batch_stats(group, size):
    """Within the scope, BatchNorm's training statistics are averaged over
    the ``size`` ranks of the process ``group`` (a no-op for one rank)."""
    prev = (_STATS.group, _STATS.size)
    _STATS.group, _STATS.size = group, int(size)
    try:
        yield
    finally:
        _STATS.group, _STATS.size = prev


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of a group, differentiable: its backward
    is the mean over the ranks of the incoming gradient, since every
    rank's loss reads the mean."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / size

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out / ctx.size, None, None


def _batch_stats(data, axis):
    """One-pass fp32 batch statistics ``E[x]`` and ``E[x²]−E[x]²``
    (clamped at 0), cast to the data dtype, as the JAX ops compute them.
    Under :func:`cross_rank_batch_stats` over N > 1 ranks the fp32 means
    ``E[x]`` and ``E[x²]`` are averaged over the ranks first (each rank
    holds as many rows)."""
    dims = tuple(i for i in range(data.dim()) if i != axis % data.dim())
    mean = torch.mean(data, dim=dims, dtype=torch.float32)
    sq = torch.mean(torch.square(data), dim=dims, dtype=torch.float32)
    if _STATS.size > 1:
        mean, sq = _RankMean.apply(torch.stack([mean, sq]), _STATS.group,
                                   _STATS.size).unbind(0)
    var = torch.clamp_min(sq - torch.square(mean), 0.0)
    return mean.to(data.dtype), var.to(data.dtype)


def _stop(t):
    """``t`` cut from the graph (a no-op where nothing is recorded)."""
    return t.detach() if t.requires_grad else t


def _fold(mean, var, gamma, beta, eps, fix_gamma):
    """fp32 per-channel (scale, shift) of normalize + affine."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(var.float() + eps) * g.float()
    return inv, beta.float() - mean.float() * inv


@register("BatchNorm", num_outputs=3, needs_training=True,
          aliases=("batch_norm",))
def batch_norm(data, gamma, beta, moving_mean, moving_var,
               eps: float = 1e-3, momentum: float = 0.9,
               fix_gamma: bool = True, use_global_stats: bool = False,
               output_mean_var: bool = False, axis: int = 1,
               cudnn_off: bool = False, training: bool = True):
    """Returns ``(out, mean, var)``; the moving-average update is the Gluon
    layer's.  The folded scale and shift are cast to the DATA dtype before
    ``data * scale + shift``, as ``_bn_apply`` does in the JAX package.
    In training the gradient of ``out`` flows through the batch statistics
    into ``data``; the returned ``mean`` and ``var`` are detached, as the
    JAX op stops their gradient."""
    if use_global_stats or not training:
        mean, var = moving_mean, moving_var
    else:
        mean, var = _batch_stats(data, axis)
    inv, shift = _fold(mean, var, gamma, beta, eps, fix_gamma)
    shp = [1] * data.dim()
    shp[axis % data.dim()] = data.shape[axis % data.dim()]
    out = data * inv.to(data.dtype).reshape(shp) \
        + shift.to(data.dtype).reshape(shp)
    return out, _stop(mean), _stop(var)


@register("_contrib_BatchNormAddRelu", num_outputs=3, needs_training=True,
          aliases=("BatchNormAddRelu",))
def batch_norm_add_relu(data, residual, gamma, beta, moving_mean, moving_var,
                        eps: float = 1e-3, momentum: float = 0.9,
                        fix_gamma: bool = True,
                        use_global_stats: bool = False,
                        output_mean_var: bool = False, axis: int = 1,
                        cudnn_off: bool = False, training: bool = True):
    """``relu(BatchNorm(data) + residual)`` as one epilogue.  Statistics as
    :func:`batch_norm`; the folded scale and shift stay in fp32 and go to
    the fused epilogue, whose backward is a kernel too.  Returns ``(out,
    mean, var)``, the statistics detached as in :func:`batch_norm`."""
    if use_global_stats or not training:
        mean, var = moving_mean, moving_var
    else:
        mean, var = _batch_stats(data, axis)
    inv, shift = _fold(mean, var, gamma, beta, eps, fix_gamma)
    out = fused_bn_add_relu_epilogue(data, inv, shift, residual,
                                     axis % data.dim())
    return out, _stop(mean), _stop(var)


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(data, gamma, beta, axis: int = -1, eps: float = 1e-5,
               output_mean_var: bool = False):
    """LayerNorm over ``axis``.  With ``MXNET_FUSED_LAYERNORM=1`` (opt-in,
    as in the JAX package) the last axis goes through the fused kernel.
    Otherwise it is composed: inputs under 4 bytes take one-pass fp32
    statistics ``E[x²]−E[x]²`` (clamped at 0) and cast the normalised
    values back, wider inputs take the two-pass mean and population
    variance in their own dtype, as the JAX op does."""
    if axis in (-1, data.dim() - 1) and not output_mean_var \
            and os.environ.get("MXNET_FUSED_LAYERNORM", "") == "1":
        return fused_layer_norm(data, gamma, beta, float(eps))
    if data.element_size() < 4:
        x32 = data.float()
        mean = x32.mean(dim=axis, keepdim=True)
        msq = (x32 * x32).mean(dim=axis, keepdim=True)
        var = torch.clamp_min(msq - mean * mean, 0.0)
        out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    else:
        mean = data.mean(dim=axis, keepdim=True)
        var = data.var(dim=axis, keepdim=True, unbiased=False)
        out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type: str = "leaky", slope: float = 0.25,
               lower_bound: float = 0.125, upper_bound: float = 0.334):
    """Leaky ReLU and its relatives; ``gelu`` is the exact (erf) GELU."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        shape = (1, -1) + (1,) * (data.dim() - 2) if data.dim() > 1 \
            else (-1,)
        return torch.where(data > 0, data, gamma.reshape(shape) * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        a, s = 1.6732632423543772, 1.0507009873554805
        return s * torch.where(data > 0, data, a * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":          # eval-mode deterministic slope
        return torch.where(data > 0, data,
                           (lower_bound + upper_bound) / 2 * data)
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax")
def softmax(data, length=None, axis: int = -1, temperature=None,
            dtype=None, use_length: bool = False):
    """Softmax over ``axis``; with ``use_length`` the entries at or past
    each row's ``length`` are masked out and come back as 0.  An integer
    input is taken as float32, as ``jax.nn.softmax`` takes it."""
    x = data / temperature if temperature else data
    if not x.is_floating_point():
        x = x.to(torch.float32)
    mask = None
    if length is not None and use_length:
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        idx = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        mask = idx < length.unsqueeze(axis)
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
    out = torch.softmax(x, dim=axis)
    if mask is not None:
        out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("Dropout", needs_training=True, aliases=("dropout",))
def dropout(data, p: float = 0.5, mode: str = "training", axes=(),
            cudnn_off: bool = True, training: bool = True):
    """Inverted dropout: the identity outside training (unless ``mode`` is
    ``"always"``); in training a Bernoulli keep-mask from the port's
    generator of the data's device (``mx.random``), the kept values scaled
    by ``1 / (1 - p)``.  ``axes`` share one mask value along them."""
    if (not training and mode != "always") or p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    probs = torch.full(shape, keep, dtype=torch.float32, device=data.device)
    mask = torch.bernoulli(probs, generator=_random.generator(data.device))
    return data * mask.to(data.dtype) / keep


@register("Embedding")
def embedding(data, weight, input_dim: int = 0, output_dim: int = 0,
              dtype="float32", sparse_grad: bool = False):
    """Rows of ``weight`` at the ids ``data`` (float ids, as MXNet passes
    them, cut to int32 and clipped to the vocabulary)."""
    if sparse_grad:
        raise MXNetError("Embedding: sparse_grad is not ported")
    idx = torch.clamp(data.to(torch.int32), 0, weight.shape[0] - 1)
    return F.embedding(idx.long(), weight)


@register("SequenceLast")
def sequence_last(data, sequence_length=None,
                  use_sequence_length: bool = False, axis: int = 0):
    """The last step of each sequence along ``axis`` (0: (T, N, ...), 1:
    (N, T, ...)): step ``sequence_length - 1`` of each row with
    ``use_sequence_length``, else the last step.  The step is taken as the
    JAX package's ``take_along_axis`` takes it: a negative step counts from
    the end (a length of 0 gives the last step), and a step past either
    end gives the fill value (NaN, or the integer type's least value)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    T = data.shape[axis]
    step = sequence_length.to(torch.int64) - 1
    step = torch.where(step < 0, step + T, step)
    inside = (step >= 0) & (step < T)
    shape = [1] * data.dim()
    shape[1 - axis] = -1
    idx = torch.clamp(step, 0, T - 1).reshape(shape)
    out = torch.take_along_dim(data, idx, dim=axis).select(axis, 0)
    fill = float("nan") if data.is_floating_point() else \
        torch.iinfo(data.dtype).min
    keep = inside.reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out, torch.full((), fill, dtype=data.dtype,
                                             device=data.device))
