"""Shape, slicing and gather operators on torch tensors.

Counterpart of the part of ``mxnet_tpu/ops/matrix.py`` the BERT and
LSTM paths use: ``batch_dot``, ``transpose``, ``swapaxes``,
``slice_axis``, ``_contrib_gather_positions``, ``Cast``, ``amp_cast``,
``zeros_like`` and ``ones_like``, and the list-signature ``concat`` and ``stack`` of
``mxnet_tpu/ndarray/ndarray.py`` (``nd.concat``/``nd.stack`` there).  Mixed
input dtypes promote as ``jnp.concatenate``/``jnp.stack`` promote them.
``Flatten`` lives in ``ops/nn.py``; the rest of the JAX module waits.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["batch_dot", "transpose", "swapaxes", "slice_axis",
           "gather_positions", "cast", "amp_cast", "zeros_like", "ones_like",
           "concat", "stack"]


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Batched matrix product over the leading axes."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("transpose")
def transpose(data, axes=None):
    """Axes permuted (reversed when ``axes`` is None or empty)."""
    if axes is None or len(tuple(axes)) == 0:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1: int = 0, dim2: int = 0):
    return data.transpose(dim1, dim2)


@register("slice_axis")
def slice_axis(data, axis: int = 0, begin: int = 0, end=None):
    """``data[..., begin:end, ...]`` on ``axis``."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("_contrib_gather_positions", aliases=("gather_positions",))
def gather_positions(data, positions):
    """Per-row gather: data (B, S, C), positions (B, P) → (B, P, C).
    Positions are clamped to ``[0, S-1]``, as in the JAX package."""
    idx = torch.clamp(positions.to(torch.int64), 0, data.shape[1] - 1)
    return torch.take_along_dim(data, idx.unsqueeze(-1), dim=1)


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("amp_cast")
def amp_cast(data, dtype="float32"):
    """``data`` in ``dtype``: the cast AMP's graph conversion inserts."""
    return data.to(torch_dtype(dtype))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("concat", aliases=("Concat",))
def concat(*data, dim: int = 1):
    """The inputs joined along the existing axis ``dim``."""
    return torch.cat(data, dim=dim)


@register("stack")
def stack(*data, axis: int = 0):
    """The inputs joined along a new axis ``axis``."""
    return torch.stack(data, dim=axis)
