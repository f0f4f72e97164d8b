"""NDArray serialization: ``mx.nd.save`` / ``mx.nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` in the same ``.npz``
format: a dict of arrays under their names, or a list under the keys
``__mx_list__:<i>``.  A file written by the JAX package's ``nd.save`` or
``save_parameters`` loads here and the other way round.  Writes are
atomic (a temporary file, then ``os.replace``).  The reader of the
upstream binary ``.params`` format waits.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Union

import numpy as onp

from .ndarray import NDArray, array

__all__ = ["save", "load"]

_LIST_PREFIX = "__mx_list__:"


def save(fname: str, data) -> None:
    """Save an NDArray, a list of them or a str -> NDArray dict."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = list(data.items())
    elif isinstance(data, (list, tuple)):
        items = [(_LIST_PREFIX + str(i), v) for i, v in enumerate(data)]
    else:
        raise TypeError("data needs to either be a NDArray, dict of str to "
                        "NDArray")
    payload: Dict[str, onp.ndarray] = {}
    for k, v in items:
        if not isinstance(v, NDArray):
            raise TypeError("save only supports NDArray values")
        payload[k] = v.asnumpy()
    directory = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-save-")
    try:
        with os.fdopen(fd, "wb") as fh:
            onp.savez(fh, **payload)
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load(fname: str, ctx=None) -> Union[List[NDArray], Dict[str, NDArray]]:
    """Load what :func:`save` wrote onto ``ctx`` (default: the current
    context)."""
    with onp.load(fname, allow_pickle=False) as z:
        keys = list(z.keys())
        if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
            items = sorted(keys, key=lambda k: int(k[len(_LIST_PREFIX):]))
            return [array(z[k], ctx=ctx) for k in items]
        return {k: array(z[k], ctx=ctx) for k in keys}
