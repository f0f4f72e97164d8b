"""Elementwise comparison operators on torch tensors.

Counterpart of the part of ``mxnet_tpu/ops/elemwise.py`` the BERT path
uses: ``broadcast_greater_equal``, whose result takes the dtype of its
first operand (1 where true, 0 where false).  The other elementwise ops
wait.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["broadcast_greater_equal"]


@register("broadcast_greater_equal", differentiable=False,
          aliases=("greater_equal",))
def broadcast_greater_equal(lhs, rhs):
    return torch.ge(lhs, rhs).to(lhs.dtype)
