"""Reduction and broadcasting operators on torch tensors.

Counterpart of ``mxnet_tpu/ops/reduce.py``: ``sum``, ``mean``, ``prod``,
``min``, ``max``, ``nansum`` and ``nanprod`` with ``axis``, ``keepdims``
and ``exclude`` (and the aliases ``sum_axis``, ``max_axis``,
``min_axis``); ``norm``; ``argmax``, ``argmin`` and ``argmax_channel``,
which return float32 as MXNet does; ``broadcast_axis`` (``broadcast_axes``),
``broadcast_to``, ``broadcast_like``, ``L2Normalization`` and ``moments``.

Result dtypes follow ``jax.numpy`` with 64-bit types off, as the JAX
package's arrays are: the sum and product of a bool or integer array are
int32 (torch would give int64), its mean and variance float32 (torch
refuses them), and a floating array keeps its dtype.  ``axis=()`` reduces
nothing, as in ``jax.numpy`` (torch would reduce every axis).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["norm", "argmax", "argmin", "argmax_channel", "broadcast_axis",
           "broadcast_to", "broadcast_like", "l2_normalization", "moments"]


def _norm_axis(axis, ndim: int, exclude: bool = False):
    """The reduced axes as a sorted tuple of non-negative ints (every
    axis for ``None``); ``exclude`` takes the complement."""
    if axis is None:
        ax = None if not exclude else ()
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    if exclude:
        inc = {a % ndim for a in ax}
        return tuple(a for a in range(ndim) if a not in inc)
    if ax is None:
        return tuple(range(ndim))
    return tuple(sorted(a % ndim for a in ax))


def _is_exact(dtype):
    return not (dtype.is_floating_point or dtype.is_complex)


def _sum_dtype(x):
    """The dtype ``jnp.sum``/``jnp.prod`` give ``x``: int32 for bool and
    integers, ``x``'s own for floating types."""
    return torch.int32 if _is_exact(x.dtype) else x.dtype


def _float(x):
    """``x`` as ``jnp.mean`` computes it: float32 for bool and integers."""
    return x.to(torch.float32) if _is_exact(x.dtype) else x


def _keep(out, x, ax, keepdims):
    """``out`` reduced over ``ax``, with those axes kept as size 1 where
    asked (for reductions torch cannot keep over several axes)."""
    if not keepdims:
        return out
    return out.reshape([1 if a in ax else n for a, n in enumerate(x.shape)])


def _prod_over(x, ax, keepdims, dtype):
    """The product over the axes ``ax``: torch's ``prod`` takes one axis,
    so the reduced axes are moved last and flattened into one."""
    rest = [a for a in range(x.dim()) if a not in ax]
    flat = x.permute(*rest, *ax).reshape([x.shape[a] for a in rest] + [-1])
    return _keep(torch.prod(flat, dim=-1, dtype=dtype), x, ax, keepdims)


def _sum(x, ax, keepdims):
    return torch.sum(x, dim=ax, keepdim=keepdims, dtype=_sum_dtype(x))


def _mean(x, ax, keepdims):
    return torch.mean(_float(x), dim=ax, keepdim=keepdims)


def _prod(x, ax, keepdims):
    return _prod_over(x, ax, keepdims, _sum_dtype(x))


def _min(x, ax, keepdims):
    return torch.amin(x, dim=ax, keepdim=keepdims)


def _max(x, ax, keepdims):
    return torch.amax(x, dim=ax, keepdim=keepdims)


def _nansum(x, ax, keepdims):
    if _is_exact(x.dtype):
        return _sum(x, ax, keepdims)
    return torch.nansum(x, dim=ax, keepdim=keepdims)


def _nanprod(x, ax, keepdims):
    if not _is_exact(x.dtype):
        x = torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype), x)
    return _prod(x, ax, keepdims)


def _reduce(fn, name):
    def op(data, axis=None, keepdims: bool = False, exclude: bool = False):
        ax = _norm_axis(axis, data.dim(), exclude)
        if not ax and data.dim():
            # no axis to reduce: the data in the result's dtype
            return fn(data.unsqueeze(0), (0,), False)
        return fn(data, ax, keepdims)
    op.__name__ = name
    op.__doc__ = ("``%s`` over ``axis`` (every axis for None; the others "
                  "with ``exclude``), dtypes as in ``jax.numpy``." % name)
    return op


for _name, _fn, _aliases in (("sum", _sum, ("sum_axis",)),
                             ("mean", _mean, ()),
                             ("prod", _prod, ()),
                             ("min", _min, ("min_axis",)),
                             ("max", _max, ("max_axis",)),
                             ("nansum", _nansum, ()),
                             ("nanprod", _nanprod, ())):
    register(_name, aliases=_aliases)(_reduce(_fn, _name))


@register("norm")
def norm(data, ord: int = 2, axis=None, keepdims: bool = False):
    """The L1 (``ord=1``) or L2 norm over ``axis`` (every axis for None)."""
    ax = _norm_axis(axis, data.dim())
    if ord == 1:
        return _sum(torch.abs(data), ax, keepdims)
    return torch.sqrt(_float(_sum(data * data, ax, keepdims)))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape([1] * data.dim())
    else:
        out = fn(data, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax", differentiable=False)
def argmax(data, axis=None, keepdims: bool = False):
    """The index of the largest value over ``axis`` (of the flattened
    array for None), as float32."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", differentiable=False)
def argmin(data, axis=None, keepdims: bool = False):
    """The index of the smallest value over ``axis``, as float32."""
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    """``argmax`` over axis 1."""
    return _arg(torch.argmax, data, 1, False)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    """Size-1 axes ``axis`` broadcast to ``size``."""
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    sz = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(ax, sz):
        shape[a] = s
    return torch.broadcast_to(data, tuple(shape))


@register("broadcast_to")
def broadcast_to(data, shape=()):
    """``data`` broadcast to ``shape``; a 0 there keeps data's size."""
    tgt = tuple(int(s) if s != 0 else d for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape, or its ``lhs_axes`` to the
    sizes of ``rhs``'s ``rhs_axes``."""
    if lhs_axes is None:
        cur = tuple(lhs.shape)
        if len(cur) < rhs.dim():
            cur = (1,) * (rhs.dim() - len(cur)) + cur
        return torch.broadcast_to(lhs.reshape(cur), rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(shape))


@register("L2Normalization")
def l2_normalization(data, eps: float = 1e-10, mode: str = "instance"):
    """``data`` over its L2 norm (plus ``eps`` under the root) per
    instance (every axis but 0), per channel (axis 1) or per position
    (``spatial``: the axes from 2 on)."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    else:
        ax = tuple(range(2, data.dim()))
    nrm = torch.sqrt(torch.sum(data * data, dim=ax, keepdim=True) + eps)
    return data / nrm


@register("moments", num_outputs=2)
def moments(data, axes=None, keepdims: bool = False):
    """Mean and (population) variance over ``axes``, the variance as
    ``jnp.var`` computes it: the mean of the squared deviations."""
    ax = _norm_axis(axes, data.dim())
    x = _float(data)
    mean = torch.mean(x, dim=ax, keepdim=True)
    dev = x - mean
    var = torch.mean(dev * dev, dim=ax, keepdim=keepdims)
    return (mean if keepdims else mean.reshape(var.shape)), var
