"""NDArray: MXNet's imperative array over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` with its whole surface:
conversion (``asnumpy``, ``asscalar``, ``item``, ``astype``,
``float()``/``int()``/``bool()``), placement (``copyto``,
``as_in_context``), the autograd surface (``attach_grad``, ``grad``,
``backward``, ``detach``), shape methods (``reshape`` with MXNet's codes,
``reshape_like``, ``flatten``, ``expand_dims``, ``squeeze``,
``broadcast_to``/``broadcast_like``, ``transpose`` and ``T``), the
arithmetic, reflected and in-place operators with ``@``, ``**``, ``%``
and ``//``, element-wise comparisons (``==`` and ``!=`` too: 1 where true,
0 where false, in the left operand's dtype, as in the JAX package; the
hash stays the identity's), indexing with integers, slices (negative
steps too), ``None``, ``...`` and integer arrays (NDArrays, numpy arrays,
lists; float indices are cut to integers and every index is clipped into
range, as the JAX package's gathers clip), item assignment, and every
registered op as a method (``a.exp()``), through the ``mx.nd`` dispatch.
The module adds the constructors ``array``, ``empty``, ``zeros``,
``ones``, ``full``, ``arange``, ``linspace``, ``eye``, ``from_numpy``,
and ``split``, ``concat``, ``stack``, ``add_n`` and ``waitall``.

The tensor lives on the context's device; the context is read from the
tensor.  Mutation rebinds the wrapped tensor (``self._data = new``), as
the JAX package rebinds its immutable buffer: ``a += b``, ``a[1:] = v``
and ``out=`` leave an array taken from ``a`` before (a slice, a view) with
its old values.  A variable (``attach_grad``) is the exception: it is
updated in place, so that it stays the leaf its gradient hook is on, and
that is refused while recording, as in the JAX package.  Every operation
runs in :func:`autograd.op_scope`, so it builds a graph only inside
``autograd.record()``.
"""
from __future__ import annotations

import numbers
from typing import List, Optional

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError, numeric_types, torch_dtype
from ..context import Context, current_context

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "linspace", "eye", "split", "concat", "stack", "add_n", "waitall",
           "from_numpy"]


class NDArray:
    """A multi-dimensional array on a device context."""

    __array_priority__ = 1000.0
    # autograd variable state, set by autograd.mark_variables
    _grad: Optional["NDArray"] = None
    _grad_req: Optional[str] = None
    _fresh_grad = False
    _hooked = None

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
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def stype(self) -> str:
        """The storage type: always dense (``"default"``)."""
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        """The gradient buffer attached by :meth:`attach_grad`."""
        return self._grad

    # -- conversion -----------------------------------------------------
    def asnumpy(self) -> onp.ndarray:
        """A host numpy copy (waits for the device)."""
        if self._data.dtype == torch.bfloat16:
            raise MXNetError("numpy has no bfloat16: call "
                             ".astype('float32').asnumpy()")
        t = self._data.detach()
        # a copy, as MXNet gives: a host tensor's numpy() would share its
        # memory, and parameters are updated in place
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        """The value of a one-element array as a numpy scalar (waits for
        the device)."""
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Wait until the value is computed."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def astorch(self) -> torch.Tensor:
        """The underlying ``torch.Tensor``."""
        return self._data

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        with autograd.op_scope():
            return _wrap(self._data.to(dt))

    # -- placement ------------------------------------------------------
    def copyto(self, other):
        """Copy into another NDArray (rebinding it, on its own device) or
        onto a Context (a new array)."""
        if isinstance(other, NDArray):
            other._data = self._data.detach().to(other._data.device)
            return other
        if isinstance(other, Context):
            return _wrap(_placed(self._data.detach().to(
                other.torch_device, copy=True), other))
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array when it is on ``ctx`` already, else a copy there."""
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def copy(self) -> "NDArray":
        """A copy on the same device."""
        with autograd.op_scope():
            return _wrap(self._data.clone())

    def tostype(self, stype):
        """This array in storage ``stype``: only dense (``"default"``)
        storage is ported, so that gives a copy and a sparse type
        raises."""
        if stype != "default":
            raise MXNetError("sparse storage (%r) is not ported" % (stype,))
        return self.copy()

    def tojson(self):
        raise AttributeError("tojson is a Symbol method")

    # -- autograd -------------------------------------------------------
    def detach(self) -> "NDArray":
        """The same value, cut from any recorded graph."""
        return _wrap(self._data.detach())

    def attach_grad(self, grad_req: str = "write", stype=None):
        """Allocate a zero gradient buffer and make this array a variable
        that ``backward`` writes (or adds) its gradient into."""
        buf = _wrap(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True):
        """Backward from this array (seeded with ones, or ``out_grad``)."""
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- reductions: the registered ops of ops/reduce.py ----------------
    def _reduce(self, name, axis, keepdims, exclude):
        # through the op dispatch, as the JAX package's methods go: AMP's
        # cast policy reads it (``sum`` and ``mean`` run in float32)
        from ..ops.registry import get_op
        from . import _make_op_func
        return _make_op_func(get_op(name))(self, axis=axis, keepdims=keepdims,
                                           exclude=exclude)

    def sum(self, axis=None, keepdims=False, exclude=False) -> "NDArray":
        return self._reduce("sum", axis, keepdims, exclude)

    def mean(self, axis=None, keepdims=False, exclude=False) -> "NDArray":
        return self._reduce("mean", axis, keepdims, exclude)

    # -- indexing -------------------------------------------------------
    def __len__(self):
        """The size of the first axis."""
        if self._data.dim() == 0:
            raise TypeError("len() of unsized object")
        return self._data.shape[0]

    def __getitem__(self, key):
        """Basic and advanced indexing (see the module's docstring)."""
        key, flips = _torch_key(key, self._data)
        with autograd.op_scope():
            data = self._data.flip(flips) if flips else self._data
            return _wrap(data[key])

    def __setitem__(self, key, value):
        """``a[key] = value``: ``a`` is rebound to a new tensor (a variable
        is written in place, and not while recording)."""
        variable = self._grad_req is not None
        if variable and autograd.is_recording():
            raise MXNetError("in-place assignment to an array that requires "
                             "grad is not supported while recording")
        cur = self._data
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, numeric_types):
            value = torch.full((), value, device=cur.device)
        else:
            value = torch.as_tensor(onp.asarray(value), device=cur.device)
        value = value.to(device=cur.device, dtype=cur.dtype)
        key, flips = _torch_key(key, cur)
        whole = all(isinstance(k, slice) and k == slice(None)
                    for k in (key if isinstance(key, tuple) else (key,)))
        with torch.no_grad() if variable else autograd.op_scope():
            if whole:
                new = torch.empty_like(cur).copy_(value)
            else:
                new = cur.flip(flips) if flips else cur.clone()
                new[key] = value
                if flips:
                    new = new.flip(flips)
            if variable:
                cur.copy_(new)
            else:
                self._data = new

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
        with autograd.op_scope():
            return _wrap(self._data.reshape(new_shape))

    def transpose(self, axes=None) -> "NDArray":
        """Axes permuted (reversed when ``axes`` is None or empty)."""
        from ..ops.matrix import transpose
        with autograd.op_scope():
            return _wrap(transpose(self._data, axes))

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return self.reshape(other.shape)

    def flatten(self) -> "NDArray":
        """(first axis, the rest flattened)."""
        return self.reshape((self.shape[0] if self.ndim else 1, -1))

    def squeeze(self, axis=None) -> "NDArray":
        from ..ops.matrix import squeeze
        with autograd.op_scope():
            return _wrap(squeeze(self._data, axis))

    def expand_dims(self, axis) -> "NDArray":
        with autograd.op_scope():
            return _wrap(self._data.unsqueeze(axis))

    def broadcast_to(self, shape) -> "NDArray":
        """This array broadcast to ``shape`` (missing leading axes of 1
        added first)."""
        shape = tuple(shape)
        cur = (1,) * (len(shape) - self.ndim) + self.shape
        with autograd.op_scope():
            return _wrap(self._data.reshape(cur).expand(shape))

    def broadcast_like(self, other) -> "NDArray":
        return self.broadcast_to(other.shape)

    def zeros_like(self, **kw) -> "NDArray":
        return _wrap(torch.zeros_like(self._data))

    def ones_like(self, **kw) -> "NDArray":
        return _wrap(torch.ones_like(self._data))

    def __getattr__(self, name):
        """A registered op as a method: ``a.op(*args, **kw)`` is
        ``mx.nd.op(a, *args, **kw)``."""
        if name.startswith("_"):
            raise AttributeError(name)
        from ..ops.registry import get_op
        op = get_op(name)
        if op is None:
            raise AttributeError("NDArray has no attribute or op %r" % name)
        from . import _make_op_func
        f = _make_op_func(op)
        return lambda *a, **kw: f(self, *a, **kw)

    # -- arithmetic -----------------------------------------------------
    def _binop(self, other, fn):
        if isinstance(other, NDArray):
            other = other._data
        elif isinstance(other, (onp.ndarray, list, tuple)):
            other = array(other, ctx=self.context)._data
        elif not isinstance(other, numeric_types):
            return NotImplemented
        with autograd.op_scope():
            return _wrap(fn(self._data, other))

    def _rbinop(self, other, fn):
        if isinstance(other, (onp.ndarray, list, tuple)):
            other = array(other, ctx=self.context)._data
        elif not isinstance(other, numeric_types):
            return NotImplemented
        with autograd.op_scope():
            return _wrap(fn(other, self._data))

    def __add__(self, o): return self._binop(o, torch.add)
    def __radd__(self, o): return self.__add__(o)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __rsub__(self, o): return self._rbinop(o, torch.sub)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __rmul__(self, o): return self.__mul__(o)
    def __truediv__(self, o): return self._binop(o, torch.div)
    def __rtruediv__(self, o): return self._rbinop(o, torch.div)
    def __floordiv__(self, o): return self._binop(o, torch.floor_divide)
    def __rfloordiv__(self, o): return self._rbinop(o, torch.floor_divide)
    def __mod__(self, o): return self._binop(o, torch.remainder)
    def __rmod__(self, o): return self._rbinop(o, torch.remainder)
    def __pow__(self, o): return self._binop(o, torch.pow)
    def __rpow__(self, o): return self._rbinop(o, torch.pow)
    def __matmul__(self, o): return self._binop(o, _matmul)
    def __rmatmul__(self, o): return self._rbinop(o, _matmul)

    def __neg__(self):
        with autograd.op_scope():
            return _wrap(torch.neg(self._data))

    def __abs__(self):
        with autograd.op_scope():
            return _wrap(torch.abs(self._data))

    def _inplace(self, res):
        """``a op= b`` rebinds ``a``; a variable (``attach_grad``) is
        updated in place instead and stays a variable, which is refused
        while recording, as in the JAX package."""
        if self._grad_req is None:
            self._data = res._data
            return self
        if autograd.is_recording():
            raise MXNetError("in-place operations on an array that requires "
                             "grad are not supported while recording")
        with torch.no_grad():
            self._data.copy_(res._data)
        return self

    def _compare(self, other, fn):
        return self._binop(other, lambda a, b: fn(a, b).to(self._data.dtype))

    def __eq__(self, o): return self._compare(o, torch.eq)
    def __ne__(self, o): return self._compare(o, torch.ne)
    def __gt__(self, o): return self._compare(o, torch.gt)
    def __ge__(self, o): return self._compare(o, torch.ge)
    def __lt__(self, o): return self._compare(o, torch.lt)
    def __le__(self, o): return self._compare(o, torch.le)

    def __iadd__(self, o): return self._inplace(self.__add__(o))
    def __isub__(self, o): return self._inplace(self.__sub__(o))
    def __imul__(self, o): return self._inplace(self.__mul__(o))
    def __itruediv__(self, o): return self._inplace(self.__truediv__(o))
    def __imod__(self, o): return self._inplace(self.__mod__(o))

    # the identity's hash, as MXNet's: NDArrays stay usable as dict keys
    # and set members although ``==`` is element-wise
    __hash__ = object.__hash__

    # pickling, in the JAX package's form: optimizer-state files of either
    # package hold NDArrays as {"data": numpy array, "ctx_kind": ...}.
    # An unpickled array lands on the host; its user moves it on.
    def __getstate__(self):
        return {"data": self.asnumpy(), "ctx_kind": self.context.device_type}

    def __setstate__(self, state):
        self._data = torch.from_numpy(onp.array(state["data"]))


_NARROW = {onp.dtype(onp.float64): onp.dtype(onp.float32),
           onp.dtype(onp.int64): onp.dtype(onp.int32)}


def _placed(t: torch.Tensor, ctx: Context) -> torch.Tensor:
    """``t`` in page-locked memory when ``ctx`` is ``cpu_pinned``."""
    return t.pin_memory() if ctx.device_type == "cpu_pinned" else t


def _to_tensor(data, ctx: Context, dtype=None) -> torch.Tensor:
    device = ctx.torch_device
    dt = torch_dtype(dtype) if dtype is not None else None
    if isinstance(data, torch.Tensor):
        return _placed(data.to(device=device, dtype=dt), ctx)
    if dt is None:
        # like the JAX package, whose arrays are at most 32-bit: a 64-bit
        # numpy source becomes its 32-bit kind (float64 float32, int64
        # int32) unless the 64-bit type is asked for
        dt = torch_dtype(_NARROW.get(data.dtype, data.dtype)) \
            if isinstance(data, onp.ndarray) else torch.float32
    arr = onp.asarray(data)
    if dt != torch.bfloat16:
        arr = arr.astype(str(dt).replace("torch.", ""), copy=False)
    return _placed(torch.as_tensor(onp.ascontiguousarray(arr))
                   .to(device=device, dtype=dt), ctx)


def _wrap(tensor: torch.Tensor) -> NDArray:
    """Wrap a tensor without copying; its context is its device's."""
    out = NDArray.__new__(NDArray)
    out._data = tensor
    return out


def _matmul(a, b):
    from ..ops.matrix import _matmul as matmul
    return matmul(a, b)


def _torch_key(key, data):
    """``key`` as torch indexes ``data``, and the axes to flip first.
    NDArray, numpy and list indices become int64 tensors on ``data``'s
    device (a float index is cut to an integer), a negative index counts
    from the end and every index is clipped into its axis, as the JAX
    package's gathers clip; a boolean numpy or list index stays a mask.
    A slice with a negative step, which torch lacks, becomes a forward
    slice of the flipped axis."""
    from ..ops.matrix import forward_slice
    parts = list(key) if isinstance(key, tuple) else [key]
    for i, p in enumerate(parts):
        if isinstance(p, NDArray):
            p = p._data
        elif isinstance(p, (list, onp.ndarray)):
            p = torch.as_tensor(onp.asarray(p), device=data.device)
        if isinstance(p, torch.Tensor) and p.dtype != torch.bool:
            p = p.to(device=data.device, dtype=torch.int64)
        parts[i] = p
    used = sum(p.dim() if isinstance(p, torch.Tensor)
               and p.dtype == torch.bool else 1 for p in parts
               if p is not None and p is not Ellipsis)
    flips, axis = [], 0
    for i, p in enumerate(parts):
        if p is None:
            continue
        if p is Ellipsis:
            axis += data.dim() - used
            continue
        if isinstance(p, torch.Tensor) and p.dtype == torch.bool:
            axis += p.dim()
            continue
        n = data.shape[axis]
        if isinstance(p, torch.Tensor):
            parts[i] = torch.clamp(torch.where(p < 0, p + n, p), 0, n - 1)
        elif isinstance(p, slice):
            flip, parts[i] = forward_slice(p, n)
            if flip:
                flips.append(axis)
        axis += 1
    key = tuple(parts) if isinstance(key, tuple) else parts[0]
    return key, tuple(flips)


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


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An array of ``shape`` (zeros, as the JAX package gives)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return _filled(shape, 0, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype=None, **kw) -> NDArray:
    return _filled(shape, 1, ctx, dtype)


def full(shape, val, ctx: Optional[Context] = None, dtype=None,
         out=None) -> NDArray:
    """An array of ``shape`` filled with ``val`` (float32 unless ``dtype``
    says otherwise), written into ``out`` when given."""
    res = _filled(shape, val, ctx, dtype)
    if out is not None:
        return out._inplace(res)
    return res


def linspace(start, stop, num, endpoint=True, ctx: Optional[Context] = None,
             dtype=None) -> NDArray:
    """``num`` evenly spaced values from ``start`` to ``stop`` (float32
    unless ``dtype`` says otherwise), in ``jnp.linspace``'s arithmetic."""
    from ..ops.matrix import linspace as _linspace
    ctx = ctx if ctx is not None else current_context()
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    dev = ctx.torch_device
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=dev)
              for v in (start, stop))
    a = _linspace(lo, hi, int(num), torch.float32, endpoint)
    if not dt.is_floating_point:
        a = torch.floor(a)
    return _wrap(a.to(dt))


def eye(N, M=0, k=0, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An N x M (N x N when M is 0) array with ones on the k-th
    diagonal."""
    ctx = ctx if ctx is not None else current_context()
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    dev = ctx.torch_device
    rows = torch.arange(N, device=dev).unsqueeze(1)
    cols = torch.arange(M if M else N, device=dev).unsqueeze(0)
    return _wrap((cols - rows == k).to(dt))


def arange(start, stop=None, step=1.0, repeat=1, ctx: Optional[Context] = None,
           dtype=None) -> NDArray:
    """``start, start + step, ...`` below ``stop`` (float32 unless
    ``dtype`` says otherwise), each value ``repeat`` times."""
    ctx = ctx if ctx is not None else current_context()
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    if stop is None:
        start, stop = 0, start
    a = torch.arange(start, stop, step, dtype=dt, device=ctx.torch_device)
    if repeat != 1:
        a = torch.repeat_interleave(a, repeat)
    return _wrap(a)


def split(data, num_outputs: int, axis: int = 1, squeeze_axis: bool = False):
    """``data`` cut into ``num_outputs`` equal parts along ``axis`` (a list,
    or the one array when ``num_outputs`` is 1)."""
    size = data.shape[axis]
    if size % num_outputs:
        raise MXNetError("split: axis %d of size %d does not split into %d"
                         % (axis, size, num_outputs))
    with autograd.op_scope():
        parts = torch.split(data._data, size // num_outputs, dim=axis)
        if squeeze_axis:
            parts = [p.squeeze(axis) for p in parts]
        out = [_wrap(p) for p in parts]
    return out[0] if num_outputs == 1 else out


def _tensors(data):
    """The tensors of ``data``: NDArrays, or one list or tuple of them."""
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = data[0]
    return [d._data for d in data]


def concat(*data, dim: int = 1, **kw) -> NDArray:
    """The arrays (or one list of them) joined along the axis ``dim``."""
    from ..ops import matrix
    with autograd.op_scope():
        return _wrap(matrix.concat(*_tensors(data), dim=dim))


def stack(*data, axis: int = 0, **kw) -> NDArray:
    """The arrays (or one list of them) joined along a new axis ``axis``."""
    from ..ops import matrix
    with autograd.op_scope():
        return _wrap(matrix.stack(*_tensors(data), axis=axis))


def add_n(*args, **kw) -> NDArray:
    """The sum of the arrays (or of one list of them), left to right."""
    with autograd.op_scope():
        tensors = _tensors(args)
        total = tensors[0]
        for t in tensors[1:]:
            total = total + t
        return _wrap(total)


def waitall():
    """Wait until every computation queued on the card has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def from_numpy(value, ctx: Optional[Context] = None) -> NDArray:
    """An NDArray holding a copy of the numpy array ``value``."""
    return array(value, ctx=ctx)
