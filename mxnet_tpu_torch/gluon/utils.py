"""Gluon utilities: carrying weights over from the JAX package.

``load_jax_params(net, arrays)`` copies arrays keyed by the structural
names of the JAX package's ``_collect_params_with_prefix()`` into the port
net's parameters of the same structural names.  Both packages keep conv
weights as OIHW and dense weights as (out, in), so no transposes are
needed.  Structural names, not prefixed ones, are the key: the
auto-naming counters give two nets built in one process different
prefixes (``resnetv10_`` vs ``resnetv11_``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as onp

from ..base import MXNetError

__all__ = ["load_jax_params"]


def load_jax_params(net, arrays: Mapping[str, onp.ndarray]) -> None:
    """Copy ``{structural name: numpy array}`` into ``net``'s parameters.
    Raises when a name is missing, left over or has another shape."""
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError("load_jax_params: missing %s, left over %s"
                         % (missing, extra))
    for name, p in params.items():
        value = onp.asarray(arrays[name])
        shape = p.shape
        if shape is None or len(shape) != value.ndim or any(
                s not in (0, v) for s, v in zip(shape, value.shape)):
            raise MXNetError("load_jax_params: %s has shape %s here, %s in "
                             "the arrays" % (name, shape, value.shape))
    for name, p in params.items():
        p.set_data(onp.asarray(arrays[name]))
