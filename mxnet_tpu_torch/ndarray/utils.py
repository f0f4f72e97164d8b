"""NDArray serialization: ``mx.nd.save`` / ``mx.nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` in the same ``.npz``
format: a dict of arrays under their names, or a list under the keys
``__mx_list__:<i>``.  A file written by the JAX package's ``nd.save`` or
``save_parameters`` loads here and the other way round.  numpy has no
bfloat16, so a bfloat16 array is stored as the JAX package stores it: its
raw 2-byte values as numpy's ``|V2`` type, which :func:`load` reads back
as bfloat16.  A file in upstream MXNet's binary format (``.params``,
first eight bytes the list magic ``0x112``) is read through
``legacy_io.py``.  Writes are atomic (a temporary file, then
``os.replace``).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, List, Union

import numpy as onp
import torch

from .ndarray import NDArray, array

__all__ = ["save", "load", "save_dict", "load_dict", "atomic_file"]

_LIST_PREFIX = "__mx_list__:"


@contextlib.contextmanager
def atomic_file(fname: str):
    """A binary file object whose content replaces ``fname`` only once
    the block ends without error."""
    directory = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-save-")
    try:
        with os.fdopen(fd, "wb") as fh:
            yield fh
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _host_array(v: NDArray) -> onp.ndarray:
    """The numpy array to store: bfloat16 as its raw 2-byte values."""
    if v._data.dtype == torch.bfloat16:
        bits = v._data.detach().view(torch.int16).cpu().numpy()
        return bits.view(onp.dtype("V2"))
    return v.asnumpy()


def _loaded(a: onp.ndarray, ctx) -> NDArray:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = torch.from_numpy(onp.ascontiguousarray(a).view(onp.int16))
        return array(bits.view(torch.bfloat16), ctx=ctx)
    return array(a, ctx=ctx)


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
        payload[k] = _host_array(v)
    with atomic_file(fname) as fh:
        onp.savez(fh, **payload)


def load(fname: str, ctx=None) -> Union[List[NDArray], Dict[str, NDArray]]:
    """Load what :func:`save` (of either package) or upstream MXNet wrote
    onto ``ctx`` (default: the current context)."""
    from . import legacy_io
    if legacy_io.is_legacy_file(fname):
        raw = legacy_io.load_legacy(fname)
        if isinstance(raw, dict):
            return {k: array(v, ctx=ctx) for k, v in raw.items()}
        return [array(v, ctx=ctx) for v in raw]
    with onp.load(fname, allow_pickle=False) as z:
        keys = list(z.keys())
        if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
            items = sorted(keys, key=lambda k: int(k[len(_LIST_PREFIX):]))
            return [_loaded(z[k], ctx) for k in items]
        return {k: _loaded(z[k], ctx) for k in keys}


def save_dict(fname: str, data: Dict[str, NDArray]) -> None:
    save(fname, data)


def load_dict(fname: str, ctx=None) -> Dict[str, NDArray]:
    """:func:`load` as a dict (a list's entries under "0", "1", ...)."""
    out = load(fname, ctx=ctx)
    if isinstance(out, list):
        return {str(i): v for i, v in enumerate(out)}
    return out
