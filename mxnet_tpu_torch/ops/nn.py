"""Neural-network operators on torch tensors.

Counterpart of ``mxnet_tpu/ops/nn.py``, every op of it: dense layers,
(transposed) convolutions and pooling, the batch, group, instance,
layer and local response norms, activations, the softmax family, the
output ops whose backward is a loss's gradient (``SoftmaxOutput``,
``SVMOutput``, ``IdentityAttachKLSparseReg``), dropout, embeddings and
the sequence ops, plus ``Flatten`` (``mxnet_tpu/ops/matrix.py`` there).
Convolutions and dense layers are ``torch.nn.functional`` calls (cuDNN
and cuBLAS on the card, as XLA's own lowering was on the TPU).  The
BatchNorm ops reproduce the JAX package's numerics exactly: one-pass
fp32 batch statistics, and the per-op difference in where the folded
scale/shift are rounded (see :func:`batch_norm` and
:func:`batch_norm_add_relu`).  The residual
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

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "upsampling", "activation", "flatten", "batch_norm",
           "batch_norm_add_relu", "sync_batch_norm", "layer_norm",
           "group_norm", "instance_norm", "lrn", "leaky_relu", "softmax",
           "log_softmax", "softmin", "softmax_activation", "softmax_output",
           "svm_output", "identity_attach_kl_sparse_reg",
           "softmax_cross_entropy", "linear_regression_output",
           "mae_regression_output", "logistic_regression_output", "dropout",
           "embedding", "sequence_mask", "sequence_last", "sequence_reverse",
           "slice_channel", "cross_rank_batch_stats"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


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


@register("Convolution", aliases=("convolution", "Convolution_v1"))
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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=(), stride=None, dilate=None,
                  pad=None, adj=None, target_shape=None, num_filter: int = 0,
                  num_group: int = 1, no_bias: bool = True, cudnn_tune=None,
                  cudnn_off: bool = False, workspace: int = 512, layout=None):
    """Transposed convolution with an (in, out / group, *k) weight: the
    input dilated by ``stride``, padded by ``d (k - 1) - p`` (``adj`` more
    on the high side) and convolved with the flipped, IO-swapped weight,
    as the JAX op composes it.  Where every ``adj`` is below its stride or
    its dilation that is one ``conv_transpose`` call (cuDNN's); otherwise
    the composition runs as written.  ``target_shape`` is ignored, as in
    the JAX op."""
    n = len(kernel) if kernel else data.dim() - 2
    s, d = _tup(stride, n), _tup(dilate, n)
    p = _tup(pad, n) if pad is not None else (0,) * n
    a = _tup(adj, n) if adj is not None else (0,) * n
    bias = None if no_bias else bias
    if all(aa < max(ss, dd) for aa, ss, dd in zip(a, s, d)):
        return _CONV_T[n](data, weight, bias, stride=s, padding=p,
                          output_padding=a, groups=num_group, dilation=d)
    k = tuple(weight.shape[2:])
    shape = tuple(data.shape[:2]) + tuple((data.shape[2 + i] - 1) * s[i] + 1
                                          for i in range(n))
    x = data.new_zeros(shape)
    x[(slice(None), slice(None)) + tuple(slice(None, None, ss) for ss in s)] \
        = data
    x = _pad_spatial(x, [(dd * (kk - 1) - pp, dd * (kk - 1) - pp + aa)
                         for kk, pp, dd, aa in zip(k, p, d, a)], 0.0)
    w = torch.flip(weight, dims=tuple(range(2, 2 + n)))
    cin, cog = w.shape[0], w.shape[1]
    w = w.reshape((num_group, cin // num_group, cog) + k).transpose(1, 2) \
        .reshape((num_group * cog, cin // num_group) + k)
    return _CONV[n](x, w, bias, dilation=d, groups=num_group)


@register("Pooling", aliases=("pooling", "Pooling_v1"))
def pooling(data, kernel=(), pool_type: str = "max", global_pool: bool = False,
            stride=None, pad=None, pooling_convention: str = "valid",
            cudnn_off: bool = False, p_value=None, count_include_pad=None,
            layout=None):
    """``max``, ``avg``, ``sum`` and ``lp`` pooling, as the JAX op's
    ``lax.reduce_window``: the input is padded explicitly (with -inf, or
    the integer type's least value, for ``max``; 0 otherwise), the
    ``full`` convention adding on the high side what the last ceil window
    needs, and then pooled with no padding of torch's own.  ``avg``
    divides by the whole kernel volume (ceil padding included) unless
    ``count_include_pad`` is False, which divides by the real elements.
    Where torch's own padding gives the same windows (the ``valid``
    convention, no pad above half the kernel, float ``max`` or ``avg``
    over the whole kernel) it is one pooling call, without the pad's
    extra pass.  Global pooling is ``max`` for ``max`` and the mean for
    any other type, as in the JAX op."""
    n = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return torch.amax(data, dim=dims, keepdim=True)
        return torch.mean(data, dim=dims, keepdim=True)
    k = _tup(kernel, n)
    s = _tup(stride, n) if stride is not None else k
    p = _tup(pad, n) if pad is not None else (0,) * n
    if pooling_convention != "full" and data.is_floating_point() \
            and all(2 * pp <= kk for pp, kk in zip(p, k)):
        if pool_type == "max":
            return _MAX_POOL[n](data, k, s, p)
        if pool_type == "avg" and count_include_pad in (None, True):
            return _AVG_POOL[n](data, k, s, p, count_include_pad=True)
    pads = []
    for i in range(n):
        hi = p[i]
        if pooling_convention == "full":
            size = data.shape[2 + i] + 2 * p[i]
            out = -(-(size - k[i]) // s[i]) + 1
            hi += max((out - 1) * s[i] + k[i] - size, 0)
        pads.append((p[i], hi))
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        x = _pad_spatial(data, pads, fill)
        if data.is_floating_point():
            return _MAX_POOL[n](x, k, s)
        return torch.amax(_windows(x, k, s), dim=tuple(range(-n, 0)))
    if pool_type in ("avg", "sum"):
        summed = _sum_pool(_pad_spatial(data, pads, 0.0), k, s)
        if pool_type == "sum":
            return summed
        if count_include_pad is None or count_include_pad:
            return summed / _prod(k)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return summed / _sum_pool(_pad_spatial(ones, pads, 0.0), k, s)
    if pool_type == "lp":
        pv = p_value or 2
        powed = _sum_pool(_pad_spatial(torch.abs(data) ** pv, pads, 0.0),
                          k, s)
        return powed ** (1.0 / pv)
    raise ValueError("unknown pool_type %r" % pool_type)


def _prod(t):
    out = 1
    for v in t:
        out *= v
    return out


def _pad_spatial(x, pads, value):
    """``x`` padded by ``(low, high)`` per spatial dim (a negative amount
    crops), with ``value``."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def _windows(x, k, s):
    """Strided windows of the spatial dims: (N, C, *out, *k), a view."""
    for i, (kk, ss) in enumerate(zip(k, s)):
        x = x.unfold(2 + i, kk, ss)
    return x


def _sum_pool(x, k, s):
    """Window sums with no padding: average pooling with a divisor of 1
    (1-D pooling as 2-D over a unit height)."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + tuple(k),
                            (1,) + tuple(s), divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, tuple(k), tuple(s), divisor_override=1)


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
          aliases=("batch_norm", "BatchNorm_v1"))
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


@register("_contrib_SyncBatchNorm", num_outputs=3, needs_training=True,
          aliases=("SyncBatchNorm",))
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var,
                    eps: float = 1e-3, momentum: float = 0.9,
                    fix_gamma: bool = True, use_global_stats: bool = False,
                    output_mean_var: bool = False, ndev: int = 1,
                    key: str = "dp", training: bool = True):
    """BatchNorm over axis 1 whose training statistics ``E[x]`` and
    ``E[x²]`` (fp32) are averaged over the ranks of the group bound by
    :func:`cross_rank_batch_stats` (an all-reduce even over one rank), and
    plain BatchNorm when no group is bound, as the JAX op is local outside
    a mapped context.  ``ndev`` and ``key`` are accepted as there."""
    if use_global_stats or not training:
        mean, var = moving_mean, moving_var
    else:
        dims = tuple(i for i in range(data.dim()) if i != 1)
        mean = torch.mean(data, dim=dims, dtype=torch.float32)
        sq = torch.mean(torch.square(data), dim=dims, dtype=torch.float32)
        if _STATS.group is not None:
            mean, sq = _RankMean.apply(torch.stack([mean, sq]), _STATS.group,
                                       _STATS.size).unbind(0)
        var = torch.clamp_min(sq - torch.square(mean), 0.0).to(data.dtype)
        mean = mean.to(data.dtype)
    inv, shift = _fold(mean, var, gamma, beta, eps, fix_gamma)
    shp = [1] * data.dim()
    shp[1] = data.shape[1]
    out = data * inv.to(data.dtype).reshape(shp) \
        + shift.to(data.dtype).reshape(shp)
    return out, _stop(mean), _stop(var)


@register("UpSampling")
def upsampling(*data, scale: int = 1, sample_type: str = "nearest",
               num_args: int = 1, num_filter: int = 0,
               multi_input_mode: str = "concat", workspace: int = 512):
    """``data[0]`` (NCHW) enlarged ``scale`` times: ``nearest`` repeats
    each pixel, ``bilinear`` interpolates at half-pixel centres with the
    edges clamped (``jax.image.resize``'s bilinear upsampling).  The other
    inputs are ignored, as in the JAX op."""
    x = data[0]
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------------------
# group, instance and local response normalization
# ---------------------------------------------------------------------------

def _normalize(x, dims, eps):
    """``(x - mean) * rsqrt(var + eps)`` over ``dims``, with the
    population variance (``jnp.var``'s)."""
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _channel_affine(x, gamma, beta):
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register("GroupNorm")
def group_norm(data, gamma, beta, num_groups: int = 1, eps: float = 1e-5,
               output_mean_var: bool = False):
    """Normalization over each group of ``C / num_groups`` channels and
    the spatial dims, then a per-channel scale and shift."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    x = _normalize(x, tuple(range(2, x.dim())), eps).reshape(data.shape)
    return _channel_affine(x, gamma, beta)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps: float = 1e-3):
    """Normalization over the spatial dims of each sample and channel,
    then a per-channel scale and shift."""
    return _channel_affine(_normalize(data, tuple(range(2, data.dim())), eps),
                           gamma, beta)


@register("LRN", aliases=("lrn",))
def lrn(data, nsize: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        knorm: float = 2.0):
    """Local response normalization across ``nsize`` neighbouring
    channels (NCHW): ``x / (knorm + alpha / nsize * Σ x²) ** beta``."""
    half = nsize // 2
    sq = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    c = data.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, nsize):
        acc = acc + sq[:, i:i + c]
    return data / torch.pow(knorm + (alpha / nsize) * acc, beta)


# ---------------------------------------------------------------------------
# the softmax family and the output (loss-head) ops
# ---------------------------------------------------------------------------

@register("log_softmax")
def log_softmax(data, axis: int = -1, temperature=None, dtype=None,
                use_length: bool = False):
    """Log of :func:`softmax` over ``axis`` (``use_length`` is accepted and
    not read, as in the JAX op); an integer input is taken as float32."""
    x = data / temperature if temperature else data
    if not x.is_floating_point():
        x = x.to(torch.float32)
    out = torch.log_softmax(x, dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


@register("softmin")
def softmin(data, axis: int = -1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("SoftmaxActivation")
def softmax_activation(data, mode: str = "instance"):
    """Softmax over the channels (``channel``) or over all but the batch
    axis (``instance``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


def _one_hot(label, k, dtype):
    """One-hot rows of ``label`` (cut to int32); a label outside
    ``[0, k)`` gives a row of zeros, as ``jax.nn.one_hot``."""
    li = label.to(torch.int32).unsqueeze(-1)
    return (li == torch.arange(k, device=label.device, dtype=torch.int32)) \
        .to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis of (rows, K) whose backward ignores the
    incoming gradient and returns ``(p - target) * scale``, the reference's
    SoftmaxGrad (SmoothSoftmaxGrad with ``smooth_alpha``) and its
    normalization ladder, as the JAX op's custom VJP."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, smooth_alpha, batch_size):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.knobs = (grad_scale, ignore_label, use_ignore, normalization,
                     smooth_alpha, batch_size)
        return out

    @staticmethod
    def backward(ctx, grad):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, smooth_alpha, \
            batch_size = ctx.knobs
        k = out.shape[-1]
        oh = _one_hot(label, k, out.dtype)
        if smooth_alpha:
            target = (1.0 - smooth_alpha) * oh \
                + (smooth_alpha / max(k - 1, 1)) * (1.0 - oh)
            dx = out - target.to(out.dtype)
        else:
            dx = out - oh
        valid = None
        if use_ignore:
            valid = label != ignore_label
            dx = dx * valid[:, None].to(dx.dtype)
        # filled on the device (a captured backward copies nothing from
        # the host), and divided there, as the JAX op divides
        scale = torch.full((), grad_scale, dtype=torch.float32,
                           device=out.device)
        if normalization == "batch":
            scale = scale / batch_size
        elif normalization == "valid":
            if valid is not None:
                scale = scale / torch.clamp_min(
                    valid.to(torch.float32).sum(), 1.0)
            else:
                scale = scale / max(int(label.shape[0]), 1)
        dx = (dx.float() * scale).to(out.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return dx, dlabel, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def softmax_output(data, label, grad_scale: float = 1.0,
                   ignore_label: float = -1.0, multi_output: bool = False,
                   use_ignore: bool = False, preserve_shape: bool = False,
                   normalization: str = "null", out_grad: bool = False,
                   smooth_alpha: float = 0.0):
    """Forward: softmax (over axis 1 of (N, C, ...) with ``multi_output``,
    else over the flattened features).  Backward: ``(p - target)`` scaled
    by ``grad_scale``, ignoring the head gradient, with ``use_ignore``/
    ``ignore_label``, ``normalization`` (``null``, ``batch``: over
    ``data.shape[0]``, ``valid``: over the labels not ignored) and
    ``smooth_alpha``."""
    knobs = (float(grad_scale), float(ignore_label), bool(use_ignore),
             str(normalization), float(smooth_alpha), int(data.shape[0]))
    if data.dim() > 2 and multi_output:
        x = torch.movedim(data, 1, -1)
        out = _SoftmaxOutput.apply(x.reshape(-1, x.shape[-1]),
                                   label.reshape(-1), *knobs)
        return torch.movedim(out.reshape(x.shape), -1, 1)
    out = _SoftmaxOutput.apply(data.reshape(data.shape[0], -1),
                               label.reshape(-1), *knobs)
    return out.reshape(data.shape) if preserve_shape else out


class _SVMOutput(torch.autograd.Function):
    """Identity whose backward is the hinge loss's gradient (L2-SVM, or
    L1-SVM with ``use_linear``), the head gradient ignored."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.knobs = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, grad):
        x, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.knobs
        at = _one_hot(label, x.shape[-1], x.dtype) > 0
        if use_linear:
            at_k = -(margin > x).to(x.dtype) * reg
            off_k = (margin > -x).to(x.dtype) * reg
        else:
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            at_k = torch.where(margin > x, 2.0 * (margin - x), zero) * -reg
            off_k = torch.where(margin > -x, -2.0 * (margin + x), zero) * -reg
        dx = torch.where(at, at_k, off_k).to(x.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return dx, dlabel, None, None, None


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin: float = 1.0,
               regularization_coefficient: float = 1.0,
               use_linear: bool = False):
    """Forward: identity; backward: the hinge loss's gradient scaled by
    ``regularization_coefficient``."""
    x = data.reshape(data.shape[0], -1)
    out = _SVMOutput.apply(x, label.reshape(-1), float(margin),
                           float(regularization_coefficient),
                           bool(use_linear))
    return out.reshape(data.shape)


class _KLSparseReg(torch.autograd.Function):
    """Identity whose backward adds the KL sparseness penalty
    ``penalty * (-rho / ma + (1 - rho) / (1 - ma))`` to the head
    gradient."""

    @staticmethod
    def forward(ctx, data, moving_avg, rho, penalty, momentum, has_ma):
        ctx.save_for_backward(data, moving_avg)
        ctx.knobs = (rho, penalty, momentum, has_ma)
        return data.clone()

    @staticmethod
    def backward(ctx, grad):
        x, moving_avg = ctx.saved_tensors
        rho, penalty, momentum, has_ma = ctx.knobs
        avg = torch.mean(x, dim=0)
        ma = momentum * moving_avg + (1.0 - momentum) * avg if has_ma \
            else avg
        ma = torch.clamp(ma, 1e-6, 1.0 - 1e-6)
        kl = penalty * (-rho / ma + (1.0 - rho) / (1.0 - ma))
        dma = torch.zeros_like(moving_avg) if ctx.needs_input_grad[1] \
            else None
        return grad + kl.expand_as(x).to(x.dtype), dma, None, None, None, \
            None


@register("IdentityAttachKLSparseReg",
          aliases=("identity_attach_KL_sparse_reg",))
def identity_attach_kl_sparse_reg(data, moving_avg=None,
                                  sparseness_target: float = 0.1,
                                  penalty: float = 0.001,
                                  momentum: float = 0.9):
    """Forward: identity; backward: the head gradient plus the KL
    sparseness penalty, against the batch average of each unit, blended
    with ``moving_avg`` by ``momentum`` when the caller passes one (the
    denominator clamped away from 0 and 1)."""
    x = data.reshape(data.shape[0], -1)
    has_ma = moving_avg is not None
    if not has_ma:
        moving_avg = torch.zeros((x.shape[-1],), dtype=x.dtype,
                                 device=x.device)
    out = _KLSparseReg.apply(x, moving_avg, float(sparseness_target),
                             float(penalty), float(momentum), has_ma)
    return out.reshape(data.shape)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """``-Σ one_hot(label) · log_softmax(data)`` over the whole batch."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(_one_hot(label, data.shape[-1], data.dtype) * logp)


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale: float = 1.0):
    """The identity (the squared loss is Gluon's ``L2Loss``)."""
    return data


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale: float = 1.0):
    return data


@register("LogisticRegressionOutput", aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale: float = 1.0):
    return torch.sigmoid(data)


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------

@register("SequenceMask")
def sequence_mask(data, sequence_length=None,
                  use_sequence_length: bool = False, value: float = 0.0,
                  axis: int = 0):
    """``value`` at and past each sequence's length along ``axis`` (0:
    (T, N, ...), 1: (N, T, ...))."""
    if not use_sequence_length or sequence_length is None:
        return data
    T = data.shape[axis]
    rest = (1,) * (data.dim() - 2)
    if axis == 0:
        shape, lshape = (T, 1) + rest, (1, -1) + rest
    else:
        shape, lshape = (1, T) + rest, (-1, 1) + rest
    idx = torch.arange(T, device=data.device).reshape(shape)
    mask = idx < sequence_length.reshape(lshape)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None,
                     use_sequence_length: bool = False, axis: int = 0):
    """The first ``sequence_length`` steps of each sequence of (T, N, ...)
    reversed, the rest kept (``axis`` is not read: the JAX op reverses
    axis 0).  Indices are taken as the JAX package's ``take_along_axis``
    takes them: a length above T reaches past the end and gives the fill
    value (NaN, or the integer type's least value)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    idx = torch.arange(T, device=data.device).reshape(-1, 1)
    L = sequence_length.to(torch.int32).to(torch.int64).reshape(1, -1)
    rev = torch.where(idx < L, L - 1 - idx, idx)
    rev = torch.where(rev < 0, rev + T, rev)
    inside = (rev >= 0) & (rev < T)
    rest = (1,) * (data.dim() - 2)
    out = torch.take_along_dim(data, torch.clamp(rev, 0, T - 1)
                               .reshape(rev.shape + rest), dim=0)
    fill = float("nan") if data.is_floating_point() else \
        torch.iinfo(data.dtype).min
    return torch.where(inside.reshape(inside.shape + rest), out,
                       torch.full((), fill, dtype=data.dtype,
                                  device=data.device))


@register("slice_channel", num_outputs=0, aliases=("SliceChannel",))
def slice_channel(data, num_outputs: int = 1, axis: int = 1,
                  squeeze_axis: bool = False):
    """``data`` cut into ``num_outputs`` equal parts along ``axis``."""
    size = data.shape[axis]
    if size % num_outputs:
        raise ValueError("slice_channel: %d does not split evenly into %d"
                         % (size, num_outputs))
    parts = torch.split(data, size // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)
