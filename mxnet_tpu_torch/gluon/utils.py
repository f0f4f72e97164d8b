"""Gluon utilities: batch splitting, global-norm clipping, file and shape
checks, and carrying weights over from the JAX package.

``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``shape_is_known`` are the counterparts of those in
``mxnet_tpu/gluon/utils.py``; ``download`` is not ported (nothing is
fetched).
``load_jax_params(net, arrays)`` copies arrays keyed by the structural
names of the JAX package's ``_collect_params_with_prefix()`` into the port
net's parameters of the same structural names.  Both packages keep conv
weights as OIHW and dense weights as (out, in), so no transposes are
needed.  Structural names, not prefixed ones, are the key: the
auto-naming counters give two nets built in one process different
prefixes (``resnetv10_`` vs ``resnetv11_``).
"""
from __future__ import annotations

import hashlib
import warnings
from typing import Mapping

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "shape_is_known", "load_jax_params"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut along ``batch_axis`` into ``num_slice`` pieces (the
    last one takes the remainder unless ``even_split`` refuses it)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(i * step,
                                (i + 1) * step if i < num_slice - 1 else size)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split as :func:`split_data` does, one piece on each
    context of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their global 2-norm is at most
    ``max_norm``; returns the norm before scaling (a float, or a 0-d
    tensor when ``check_isfinite`` is False and no sync is wanted)."""
    with torch.no_grad():
        total = sum(torch.sum(torch.square(a._data.float())) for a in arrays)
        total_norm = torch.sqrt(total)
        if check_isfinite and not bool(torch.isfinite(total_norm)):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
        scale = torch.clamp_max(max_norm / (total_norm + 1e-8), 1.0)
        for a in arrays:
            a._data = a._data * scale.to(a._data.dtype)
    return float(total_norm) if check_isfinite else total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def shape_is_known(shape):
    """Whether ``shape`` is given and has no unknown (0 or negative)
    dimension."""
    if shape is None:
        return False
    return all(s > 0 for s in shape)


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
