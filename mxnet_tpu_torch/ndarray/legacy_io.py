"""Reader and writer of MXNet's binary NDArray file format.

The port's copy of ``mxnet_tpu/ndarray/legacy_io.py`` (which imports no
JAX), for the format of upstream MXNet's ``.params`` and checkpoint files
(``src/ndarray/ndarray.cc``: ``NDArray::Save``, V1/V2/V3 magics, storage
type, shape, context, dtype, raw buffer; the list container with magic
``0x112``).  ``nd.load`` recognises such a file by its first eight bytes
and reads it through :func:`load_legacy`; :func:`save_legacy` writes the
V2 dense format.

Dense arrays only; a sparse entry raises.  64-bit integer and float
entries are read as they are and narrowed to 32 bits when they become
NDArrays, as every ``nd.array`` of a 64-bit numpy array is.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

import numpy as onp

from ..base import MXNetError
from .utils import atomic_file

__all__ = ["LIST_MAGIC", "is_legacy_file", "load_legacy", "save_legacy"]

LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8   # int64 TShape, no storage type field
_V2_MAGIC = 0xF993FAC9   # + storage type
_V3_MAGIC = 0xF993FACA   # + np shape semantics

# mshadow type_flag <-> numpy (mshadow/base.h kFloat32..kInt64)
_TYPE_TO_NP = {0: onp.float32, 1: onp.float64, 2: onp.float16,
               3: onp.uint8, 4: onp.int32, 5: onp.int8, 6: onp.int64}
_NP_TO_TYPE = {onp.dtype(v): k for k, v in _TYPE_TO_NP.items()}


class _Reader:
    def __init__(self, buf: bytes):
        self._b = buf
        self._o = 0

    def take(self, n: int) -> bytes:
        if self._o + n > len(self._b):
            raise MXNetError("truncated legacy NDArray file")
        out = self._b[self._o:self._o + n]
        self._o += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def is_legacy_file(fname: str) -> bool:
    """First 8 bytes == the list magic 0x112 (little endian)."""
    with open(fname, "rb") as f:
        head = f.read(8)
    return len(head) == 8 and struct.unpack("<Q", head)[0] == LIST_MAGIC


def _read_shape(r: _Reader, magic: int) -> Tuple[int, ...]:
    if magic in (_V1_MAGIC, _V2_MAGIC, _V3_MAGIC):
        ndim = r.i32()
        return tuple(struct.unpack("<%dq" % ndim, r.take(8 * ndim)))
    # pre-V1 legacy: the magic itself was the (uint32) ndim, uint32 dims
    ndim = magic
    return tuple(struct.unpack("<%dI" % ndim, r.take(4 * ndim)))


def _read_ndarray(r: _Reader) -> onp.ndarray:
    magic = r.u32()
    if magic in (_V2_MAGIC, _V3_MAGIC):
        stype = r.i32()
        if stype != 0:
            raise MXNetError(
                "legacy file contains a sparse (stype=%d) entry; only "
                "dense .params are supported" % stype)
        shape = _read_shape(r, magic)
    elif magic == _V1_MAGIC:
        shape = _read_shape(r, magic)
    else:
        shape = _read_shape(r, magic)      # pre-V1: magic == ndim
    if len(shape) == 0:
        return onp.zeros((), onp.float32)  # "none" placeholder
    r.i32()                                # context dev_type
    r.i32()                                # context dev_id
    type_flag = r.i32()
    np_dtype = _TYPE_TO_NP.get(type_flag)
    if np_dtype is None:
        raise MXNetError("unknown mshadow type_flag %d" % type_flag)
    count = 1
    for s in shape:
        count *= s
    data = onp.frombuffer(r.take(count * onp.dtype(np_dtype).itemsize),
                          dtype=np_dtype)
    return data.reshape(shape).copy()


def load_legacy(fname: str) -> Union[List, Dict[str, onp.ndarray]]:
    """Parse an upstream-format file → list or dict of numpy arrays."""
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != LIST_MAGIC:
        raise MXNetError("%r is not a legacy NDArray file" % fname)
    r.u64()                                # reserved
    n_arrays = r.u64()                     # dmlc vector<NDArray> size
    arrays = [_read_ndarray(r) for _ in range(n_arrays)]
    n_names = r.u64()                      # dmlc vector<string> size
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.take(ln).decode("utf-8"))
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise MXNetError("legacy file name/array count mismatch")
    return dict(zip(names, arrays))


def save_legacy(fname: str, data) -> None:
    """Write a list or a str -> array dict in the upstream V2 dense format
    (bfloat16, which the format lacks, raises: cast it first)."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    chunks = [struct.pack("<QQ", LIST_MAGIC, 0),
              struct.pack("<Q", len(arrays))]
    for a in arrays:
        npa = a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)
        if npa.ndim == 0:
            raise MXNetError(
                "the upstream format cannot represent 0-d arrays (ndim==0 "
                "marks an empty placeholder); reshape to (1,) first")
        tf = _NP_TO_TYPE.get(onp.dtype(npa.dtype))
        if tf is None:
            raise MXNetError(
                "dtype %s has no legacy type_flag (bf16 is not "
                "representable upstream: cast first)" % npa.dtype)
        chunks.append(struct.pack("<I", _V2_MAGIC))
        chunks.append(struct.pack("<i", 0))                  # dense
        chunks.append(struct.pack("<i", npa.ndim))
        chunks.append(struct.pack("<%dq" % npa.ndim, *npa.shape))
        chunks.append(struct.pack("<ii", 1, 0))              # cpu ctx
        chunks.append(struct.pack("<i", tf))
        chunks.append(onp.ascontiguousarray(npa).tobytes())
    chunks.append(struct.pack("<Q", len(names)))
    for n in names:
        raw = n.encode("utf-8")
        chunks.append(struct.pack("<Q", len(raw)))
        chunks.append(raw)
    # atomic (a temporary file, then os.replace), as nd.save writes
    with atomic_file(fname) as f:
        f.write(b"".join(chunks))
