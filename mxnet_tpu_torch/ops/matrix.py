"""Shape, slicing and gather operators on torch tensors.

Counterpart of the part of ``mxnet_tpu/ops/matrix.py`` the BERT path uses:
``batch_dot``, ``transpose``, ``slice_axis``, ``_contrib_gather_positions``
and ``Cast``.  ``Flatten`` lives in ``ops/nn.py``; the rest of the JAX
module waits.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["batch_dot", "transpose", "slice_axis", "gather_positions", "cast"]


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
