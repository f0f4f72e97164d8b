"""The AMP overflow probes of ``mxnet_tpu/ops/contrib_ops.py``:
``all_finite`` and ``multi_all_finite``.  The rest of that module waits
(``ROADMAP.md``, queue 1, "The remainder")."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["all_finite", "multi_all_finite"]


@register("all_finite", differentiable=False)
def all_finite(data, init_output: bool = True):
    """1.0 iff every element of ``data`` is finite, as a float32 array of
    shape (1,)."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays: int = 1, init_output: bool = True):
    """:func:`all_finite` over every array in one reduction: the largest
    magnitude of each floating array (one multi-tensor pass, NaN where it
    holds one) and one test of them all."""
    floats = [a for a in arrays if a.is_floating_point() and a.numel()]
    if not floats:
        device = arrays[0].device if arrays else None
        return torch.ones(1, dtype=torch.float32, device=device)
    peaks = torch._foreach_norm(floats, float("inf"))
    return torch.isfinite(torch.stack(peaks)).all().to(
        torch.float32).reshape(1)
