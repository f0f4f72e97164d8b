"""NDArray: MXNet's imperative array over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``, carrying over what the
Gluon layers and the serving path use: ``asnumpy``, ``shape``, ``dtype``,
``context``, ``astype``, arithmetic, ``reshape`` with MXNet's special
codes (``Flatten`` uses it), and the ``array``/``zeros``/``ones``
constructors.  The tensor lives on the context's device; its context is
read from the tensor.  Updates rebind the wrapped tensor
(``self._data = new``) as the JAX package does.
"""
from __future__ import annotations

import numbers
from typing import List, Optional

import numpy as onp
import torch

from ..base import MXNetError, numeric_types, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros", "ones"]


class NDArray:
    """A multi-dimensional array on a device context."""

    __array_priority__ = 1000.0

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        ctx = ctx if ctx is not None else current_context()
        self._data = _to_tensor(data, ctx, dtype)

    # -- properties -----------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype, or ``torch.bfloat16``, which numpy lacks."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return onp.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def context(self) -> Context:
        return Context.from_device(self._data.device)

    # -- conversion -----------------------------------------------------
    def asnumpy(self) -> onp.ndarray:
        """Copy to a host numpy array (waits for the device)."""
        if self._data.dtype == torch.bfloat16:
            raise MXNetError("numpy has no bfloat16: call "
                             ".astype('float32').asnumpy()")
        return self._data.detach().cpu().numpy()

    def astorch(self) -> torch.Tensor:
        """The underlying ``torch.Tensor``."""
        return self._data

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return _wrap(self._data.to(dt))

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self._data, "x".join(map(str, self.shape)), self.context)

    def __array__(self, dtype=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- shape ----------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """MXNet reshape codes: 0 copies a dim, -1 infers, -2 copies the
        rest, -3 merges two dims, -4 splits one."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None and not shape:
            shape = tuple(kwargs["shape"])
        new_shape = _infer_reshape(self.shape, shape,
                                   kwargs.get("reverse", False))
        return _wrap(self._data.reshape(new_shape))

    # -- arithmetic -----------------------------------------------------
    def _binop(self, other, fn):
        if isinstance(other, NDArray):
            return _wrap(fn(self._data, other._data))
        if isinstance(other, numeric_types):
            return _wrap(fn(self._data, other))
        if isinstance(other, (onp.ndarray, list, tuple)):
            return _wrap(fn(self._data, array(other, ctx=self.context)._data))
        return NotImplemented

    def _rbinop(self, other, fn):
        if isinstance(other, numeric_types):
            return _wrap(fn(other, self._data))
        if isinstance(other, (onp.ndarray, list, tuple)):
            return _wrap(fn(array(other, ctx=self.context)._data, self._data))
        return NotImplemented

    def __add__(self, o): return self._binop(o, torch.add)
    def __radd__(self, o): return self.__add__(o)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __rsub__(self, o): return self._rbinop(o, torch.sub)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __rmul__(self, o): return self.__mul__(o)
    def __truediv__(self, o): return self._binop(o, torch.div)
    def __rtruediv__(self, o): return self._rbinop(o, torch.div)
    def __neg__(self): return _wrap(torch.neg(self._data))

    def _inplace(self, res):
        self._data = res._data
        return self

    def __iadd__(self, o): return self._inplace(self.__add__(o))
    def __isub__(self, o): return self._inplace(self.__sub__(o))
    def __imul__(self, o): return self._inplace(self.__mul__(o))
    def __itruediv__(self, o): return self._inplace(self.__truediv__(o))

    __hash__ = object.__hash__


def _to_tensor(data, ctx: Context, dtype=None) -> torch.Tensor:
    device = ctx.torch_device
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=dt)
    if dt is None:
        # like the JAX package, whose arrays are at most 32-bit: a float64
        # numpy source becomes float32 unless float64 is asked for
        dt = torch_dtype(data.dtype) if isinstance(data, onp.ndarray) \
            and data.dtype != onp.float64 else torch.float32
    arr = onp.asarray(data)
    if dt != torch.bfloat16:
        arr = arr.astype(str(dt).replace("torch.", ""), copy=False)
    return torch.as_tensor(onp.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dt)


def _wrap(tensor: torch.Tensor) -> NDArray:
    """Wrap a tensor without copying; its context is its device's."""
    out = NDArray.__new__(NDArray)
    out._data = tensor
    return out


def _infer_reshape(cur_shape, target, reverse=False):
    if reverse:
        cur_shape = tuple(reversed(cur_shape))
        target = tuple(reversed(target))
    out: List[int] = []
    src = list(cur_shape)
    i = 0
    infer_at = None
    t = 0
    while t < len(target):
        d = target[t]
        if d == 0:
            out.append(src[i]); i += 1
        elif d == -1:
            infer_at = len(out); out.append(1)
        elif d == -2:
            out.extend(src[i:]); i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif d == -4:
            f1, f2 = target[t + 1], target[t + 2]
            if f1 == -1:
                f1 = src[i] // f2
            if f2 == -1:
                f2 = src[i] // f1
            out.extend([f1, f2]); i += 1; t += 2
        else:
            out.append(int(d))
            if i < len(src):
                i += 1
        t += 1
    total = 1
    for s in cur_shape:
        total *= s
    if infer_at is not None:
        known = 1
        for j, s in enumerate(out):
            if j != infer_at:
                known *= s
        out[infer_at] = total // known
    if reverse:
        out = list(reversed(out))
    return tuple(out)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray holding a copy of ``source_array`` (default float32, or
    the numpy array's own dtype)."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    out = NDArray.__new__(NDArray)
    out._data = _to_tensor(source_array,
                           ctx if ctx is not None else current_context(), dtype)
    return out


def _filled(shape, value, ctx, dtype) -> NDArray:
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, numbers.Integral):
        shape = (int(shape),)
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    return _wrap(torch.full(tuple(shape), value, dtype=dt,
                            device=ctx.torch_device))


def zeros(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return _filled(shape, 0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return _filled(shape, 1, ctx, dtype)

