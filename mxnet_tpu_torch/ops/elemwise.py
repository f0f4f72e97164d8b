"""Elementwise comparison operators on torch tensors.

Counterpart of the part of ``mxnet_tpu/ops/elemwise.py`` the BERT and
LSTM paths use: ``broadcast_greater_equal``, whose result takes the dtype
of its first operand (1 where true, 0 where false), ``where`` (a nonzero
condition takes ``x``) and the ``sigmoid`` and ``tanh`` of the recurrent
cells.  The other elementwise ops wait.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["broadcast_greater_equal", "where", "sigmoid", "tanh"]


@register("broadcast_greater_equal", differentiable=False,
          aliases=("greater_equal",))
def broadcast_greater_equal(lhs, rhs):
    return torch.ge(lhs, rhs).to(lhs.dtype)


@register("where")
def where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("sigmoid")
def sigmoid(data):
    return torch.sigmoid(data)


@register("tanh")
def tanh(data):
    return torch.tanh(data)
