"""Matrix, shape, indexing, ordering and linear-algebra operators on torch
tensors.

Counterpart of ``mxnet_tpu/ops/matrix.py``, every name it registers
(``Flatten`` lives in ``ops/nn.py``), plus the list-signature ``concat``
and ``stack`` of ``mxnet_tpu/ndarray/ndarray.py``.  The results keep the
JAX package's dtypes with 64-bit types off: torch indexes with int64
inside, and the index outputs come back as float32 (``topk``,
``argsort``) or int32 (``shape_array``, ``size_array``) unless ``dtype``
says otherwise.  Indices are clipped into range where the JAX package's
gathers clip them (``take``, ``pick``, ``gather_nd``; a negative index
counts from the end first, as ``x[i]`` does there), so no gather on the
card reads out of bounds.  Orderings break ties by the lower index, as
``jax.lax.top_k`` and ``jnp.argsort`` do (a stable sort); a descending
``sort``/``argsort`` flips the ascending one, as the JAX package does.
The ``linalg_*`` ops are ``torch.linalg``'s (cuSOLVER and cuBLAS on the
card), in the JAX package's formulas.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

__all__ = ["dot", "batch_dot", "transpose", "reshape", "slice_axis",
           "gather_positions", "take", "topk", "sort", "argsort", "concat",
           "stack"]


def _matmul(a, b):
    """``a @ b`` in the operands' common dtype; integers by a broadcast
    product and sum (cuBLAS has no integer product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if dt.is_floating_point:
        return torch.matmul(a, b)
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


@register("dot")
def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """MXNet's dot: the last axis of ``lhs`` against the first of ``rhs``
    (a tensordot over one axis, not ``matmul`` for N-d operands); a
    transposed N-d operand has all its axes reversed."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return _matmul(a.unsqueeze(0), b.unsqueeze(1)).reshape(())
    out_shape = a.shape[:-1] + b.shape[1:]
    return _matmul(a.reshape(-1, a.shape[-1]),
                   b.reshape(b.shape[0], -1)).reshape(out_shape)


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Batched matrix product over the leading axes, in the operands'
    common dtype (float32 probabilities against float16 values give
    float32, as ``jnp.matmul`` promotes)."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return _matmul(a, b)


@register("transpose")
def transpose(data, axes=None):
    """Axes permuted (reversed when ``axes`` is None or empty)."""
    if axes is None or len(tuple(axes)) == 0:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1: int = 0, dim2: int = 0):
    return data.transpose(dim1, dim2)


@register("expand_dims")
def expand_dims(data, axis: int = 0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                        else axis)


@register("Reshape", aliases=("reshape",))
def reshape(data, shape=(), reverse: bool = False, target_shape=None,
            keep_highest: bool = False):
    """Reshape with MXNet's codes 0/-1/-2/-3/-4 (``reverse`` reads them
    from the right); the legacy ``target_shape`` infers its 0 entries, and
    ``keep_highest`` keeps the first axis."""
    from ..ndarray.ndarray import _infer_reshape
    if target_shape:
        tgt = [(-1 if d == 0 else int(d)) for d in target_shape]
        if keep_highest:
            tgt[0] = data.shape[0]
        return data.reshape(tuple(tgt))
    return data.reshape(_infer_reshape(tuple(data.shape), tuple(shape),
                                       reverse=reverse))


def forward_slice(s, n):
    """A slice ``s`` of an axis of ``n`` as torch takes it: ``(False, s)``
    for a forward step, or ``(True, t)`` with ``t`` a forward slice of the
    flipped axis that picks the same elements in the same order (torch's
    slicing has no negative step)."""
    if s.step is None or s.step > 0:
        return False, s
    picked = range(*s.indices(n))
    if len(picked) == 0:
        return True, slice(0, 0)
    return True, slice(n - 1 - picked[0], n - picked[-1], -s.step)


def _sliced(data, axis, begin, end, step):
    """``data[..., begin:end:step, ...]`` on ``axis``."""
    flip, s = forward_slice(slice(begin, end, step), data.shape[axis])
    if flip:
        data = data.flip(axis)
    idx = [slice(None)] * data.dim()
    idx[axis] = s
    return data[tuple(idx)]


@register("slice")
def slice_op(data, begin=(), end=(), step=()):
    """``data[b0:e0:s0, b1:e1:s1, ...]`` (None entries take the default)."""
    step = step or (None,) * len(begin)
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        data = _sliced(data, axis, b, e, s)
    return data


@register("slice_axis")
def slice_axis(data, axis: int = 0, begin: int = 0, end=None):
    """``data[..., begin:end, ...]`` on ``axis``."""
    return _sliced(data, axis, begin, end, None)


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


def _index(indices, size, mode="clip"):
    """int64 indices into an axis of ``size``: wrapped (``mode="wrap"``)
    or clipped into ``[0, size - 1]``."""
    idx = indices.to(torch.int64)
    if mode == "wrap":
        return torch.remainder(idx, size)
    return torch.clamp(idx, 0, size - 1)


@register("take")
def take(a, indices, axis: int = 0, mode: str = "clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (cut to integers,
    then clipped or wrapped): ``a.shape[:axis] + indices.shape +
    a.shape[axis + 1:]``."""
    axis = axis % a.dim()
    idx = _index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def pick(data, index, axis: int = -1, keepdims: bool = False,
         mode: str = "clip"):
    """``data`` at ``index`` along ``axis`` (clipped, whatever ``mode``, as
    in the JAX package)."""
    idx = _index(index, data.shape[axis]).unsqueeze(axis)
    picked = torch.take_along_dim(data, idx, dim=axis)
    return picked if keepdims else picked.squeeze(axis)


@register("one_hot", differentiable=False)
def one_hot(indices, depth: int = 0, on_value: float = 1.0,
            off_value: float = 0.0, dtype="float32"):
    """``indices`` (cut to integers) one-hot over ``depth`` in ``dtype``,
    an index out of range giving a row of ``off_value``; then
    ``* (on_value - off_value) + off_value``, which promotes an integer
    ``dtype`` to float32 as in the JAX package."""
    idx = indices.to(torch.int64)
    valid = (idx >= 0) & (idx < depth)
    dt = torch_dtype(dtype)
    oh = torch.zeros(idx.shape + (depth,), dtype=dt, device=idx.device)
    oh.scatter_(-1, idx.clamp(0, depth - 1).unsqueeze(-1),
                valid.to(dt).unsqueeze(-1))
    if dt.is_floating_point and (on_value, off_value) == (1.0, 0.0):
        return oh        # the same bits, without two passes over the array
    return oh * (on_value - off_value) + off_value


def _nd_index(indices, shape):
    """The rows of ``indices`` (M, ...) as a tuple of int64 index tensors
    into the first M axes of ``shape``, a negative index counting from the
    end, then clipped into range."""
    idx = indices.to(torch.int64)
    out = []
    for i in range(idx.shape[0]):
        n = shape[i]
        row = torch.where(idx[i] < 0, idx[i] + n, idx[i])
        out.append(torch.clamp(row, 0, n - 1))
    return tuple(out)


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``."""
    return data[_nd_index(indices, data.shape)]


@register("_contrib_gather_positions", aliases=("gather_positions",))
def gather_positions(data, positions):
    """Per-row gather: data (B, S, C), positions (B, P) → (B, P, C).
    Positions are clamped to ``[0, S-1]``, as in the JAX package."""
    idx = torch.clamp(positions.to(torch.int64), 0, data.shape[1] - 1)
    return torch.take_along_dim(data, idx.unsqueeze(-1), dim=1)


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    """A zero array of ``shape`` with ``data`` added at ``indices``:
    values at a repeated index add up, as ``.at[idx].add`` adds them; an
    index past the end is dropped, as the JAX scatter drops it."""
    shape = tuple(shape)
    idx = indices.to(torch.int64)
    keep = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for i in range(idx.shape[0]):
        keep &= (idx[i] >= -shape[i]) & (idx[i] < shape[i])
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    vals = data * keep.reshape(keep.shape + (1,) * (data.dim() - keep.dim()))
    return out.index_put_(_nd_index(idx, shape), vals.to(data.dtype),
                          accumulate=True)


@register("repeat")
def repeat(data, repeats: int = 1, axis=None):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    array when ``axis`` is None)."""
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("reverse", aliases=("flip",))
def reverse(data, axis=()):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, ax)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of an axis of ``n`` padded by ``lo`` and ``hi``:
    the edge repeated (``"edge"``) or mirrored without it
    (``"reflect"``, as ``jnp.pad``)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@register("Pad", aliases=("pad",))
def pad(data, mode: str = "constant", pad_width=(), constant_value: float = 0.0):
    """``data`` padded by ``pad_width`` (before and after each axis, in
    axis order): a constant, the edge value, or a reflection."""
    pairs = [(int(pad_width[i]), int(pad_width[i + 1]))
             for i in range(0, len(pad_width), 2)]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        return F.pad(data, flat, mode="constant", value=constant_value)
    for axis, (lo, hi) in enumerate(pairs):
        if lo or hi:
            data = torch.index_select(
                data, axis, _pad_index(data.shape[axis], lo, hi, mode,
                                       data.device))
    return data


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("amp_cast")
def amp_cast(data, dtype="float32"):
    """``data`` in ``dtype``: the cast AMP's graph conversion inserts."""
    return data.to(torch_dtype(dtype))


def _filled_with(values, dtype, device):
    """A vector of ``values`` on ``device``, written element by element:
    no copy from the host, which a CUDA graph's capture would refuse."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)          # a fill launch; ``out[i] = v`` copies
    return out


@register("shape_array", differentiable=False)
def shape_array(data):
    """The shape as int32 (the JAX package's widest integer)."""
    return _filled_with(data.shape, torch.int32, data.device)


@register("size_array", differentiable=False)
def size_array(data):
    return _filled_with([data.numel()], torch.int32, data.device)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("diag")
def diag(data, k: int = 0, axis1: int = 0, axis2: int = 1):
    """A diagonal matrix of a vector, or the ``k``-th diagonal of an
    array over ``axis1`` and ``axis2``."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


# --- ordering --------------------------------------------------------------
def _descending_stable(x):
    """Values and int64 indices of ``x`` sorted descending on its last
    axis, equal values in index order (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


@register("topk", differentiable=False)
def topk(data, axis: int = -1, k: int = 1, ret_typ: str = "indices",
         is_ascend: bool = False, dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties to
    the lower index: their indices (float32 unless ``dtype`` says), values,
    both, or a mask of the values at or past the k-th (``"mask"``, which
    marks every tie of the k-th, as in the JAX package)."""
    x = data if not is_ascend else -data
    x = x.movedim(axis, -1)
    if ret_typ == "mask":
        kth = torch.sort(x, dim=-1).values[..., -k].unsqueeze(-1)
        return (x >= kth).to(data.dtype).movedim(-1, axis)
    if ret_typ not in ("indices", "value", "both"):
        raise ValueError("topk: unknown ret_typ %r" % ret_typ)
    vals, idx = _descending_stable(x)
    vals, idx = vals[..., :k], idx[..., :k]
    if is_ascend:
        vals = -vals
    vals = vals.movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


@register("sort")
def sort(data, axis: int = -1, is_ascend: bool = True):
    s = torch.sort(data, dim=axis, stable=True).values
    return s if is_ascend else torch.flip(s, (axis,))


@register("argsort", differentiable=False)
def argsort(data, axis: int = -1, is_ascend: bool = True, dtype="float32"):
    """Indices of the stable ascending sort (float32 unless ``dtype``
    says), flipped for ``is_ascend=False``: ties then come out highest
    index first, as in the JAX package."""
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(dtype))


@register("depth_to_space")
def depth_to_space(data, block_size: int = 1):
    """(N, C, H, W) → (N, C / b², H b, W b), channel ``(i b + j) C / b² +
    c`` to position ``(h b + i, w b + j)`` (the JAX package's order)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size: int = 1):
    """The inverse of ``depth_to_space``."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("tril")
def tril(data, k: int = 0):
    return torch.tril(data, k)


def linspace(lo, hi, num, dtype, endpoint=True):
    """``jnp.linspace(lo, hi, num, endpoint)`` on 0-d tensors, in its
    arithmetic: ``lo * (1 - t) + hi * t`` with ``t = i / div``, the last
    value ``hi`` itself when ``endpoint``."""
    div = num - 1 if endpoint else num
    if num <= 1:
        return lo.reshape(1)[:num].to(dtype)
    # a device tensor as the divisor: CUDA divides by a host scalar as a
    # product with its reciprocal, which rounds otherwise than the CPU
    t = torch.arange(div, device=lo.device, dtype=torch.float32) \
        / torch.full((), div, dtype=torch.float32, device=lo.device)
    out = lo * (1 - t) + hi * t
    if endpoint:
        out = torch.cat([out, hi.reshape(1)])
    return out.to(dtype)


@register("histogram", differentiable=False, num_outputs=2)
def histogram(data, bin_cnt=None, range=None):
    """Counts (float32) of ``data`` in ``bin_cnt`` equal bins over
    ``range`` (default: the data's min and max, widened by 0.5 each way
    when they are equal), and the bins' edges, as ``jnp.histogram``
    counts: a value on the last edge falls in the last bin, values outside
    fall in none.  On the tensor's device, with no read back to the
    host."""
    bins = bin_cnt or 10
    x = data.reshape(-1)
    dt = x.dtype if x.is_floating_point() else torch.float32
    if range is None:
        lo, hi = x.min().to(dt), x.max().to(dt)
    else:
        lo = torch.full((), range[0], dtype=dt, device=x.device)
        hi = torch.full((), range[1], dtype=dt, device=x.device)
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    edges = linspace(lo, hi, bins + 1, dt)
    xb = x.to(dt)
    pos = torch.bucketize(xb, edges, right=True)
    pos = torch.where(xb == edges[-1], bins, pos)
    # a scatter-add of ones (bincount would read its maximum on the host)
    counts = torch.zeros(bins + 2, dtype=torch.int64, device=x.device) \
        .scatter_add_(0, pos, torch.ones_like(pos))[1:bins + 1]
    return counts.to(torch.float32), edges


# --- linalg ----------------------------------------------------------------
def _mT(x, flag=True):
    return x.transpose(-1, -2) if flag else x


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a: bool = False, transpose_b: bool = False,
                alpha: float = 1.0, beta: float = 1.0, axis: int = -3):
    return alpha * torch.matmul(_mT(A, transpose_a), _mT(B, transpose_b)) \
        + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a: bool = False, transpose_b: bool = False,
                 alpha: float = 1.0, axis: int = -3):
    return alpha * torch.matmul(_mT(A, transpose_a), _mT(B, transpose_b))


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor."""
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(A):
    """``inv(A Aᵀ)`` of a Cholesky factor ``A``."""
    return torch.linalg.inv(torch.matmul(A, _mT(A)))


@register("linalg_trmm")
def linalg_trmm(A, B, transpose: bool = False, rightside: bool = False,
                lower: bool = True, alpha: float = 1.0):
    """``alpha op(A) B`` (or ``alpha B op(A)``), ``A`` taken whole as in
    the JAX package."""
    a = _mT(A, transpose)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_trsm")
def linalg_trsm(A, B, transpose: bool = False, rightside: bool = False,
                lower: bool = True, alpha: float = 1.0):
    """``X`` with ``op(A) X = alpha B`` (or ``X op(A) = alpha B``), ``A``
    triangular."""
    a = _mT(A, transpose)
    return torch.linalg.solve_triangular(a, alpha * B,
                                         upper=(lower == transpose),
                                         left=not rightside)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk")
def linalg_syrk(A, transpose: bool = False, alpha: float = 1.0):
    a_t = _mT(A)
    return alpha * (torch.matmul(a_t, A) if transpose else torch.matmul(A, a_t))


@register("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorization ``A = L Q`` of A (..., m, n), m <= n: Q (..., m, n)
    with orthonormal rows and L (..., m, m) lower triangular with a
    positive diagonal, from the QR factorization of ``Aᵀ``."""
    qt, rt = torch.linalg.qr(_mT(A), mode="reduced")
    L, Q = _mT(rt), _mT(qt)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(A.dtype)
    return Q * s.unsqueeze(-1), L * s.unsqueeze(-2)


@register("_ravel_multi_index", aliases=("ravel_multi_index",))
def ravel_multi_index(data, shape=()):
    """Multi-indices (d, N) → flat indices (N,) over ``shape``."""
    shape = tuple(int(s) for s in shape)
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    st = _filled_with(list(reversed(strides)), data.dtype, data.device)
    flat = (st.reshape((-1,) + (1,) * (data.dim() - 1)) * data).sum(0)
    return flat.to(data.dtype)


@register("_unravel_index", aliases=("unravel_index",))
def unravel_index(data, shape=()):
    """Flat indices (N,) → multi-indices (d, N) over ``shape``."""
    idx = data.to(torch.int32)
    outs = []
    for s in reversed(tuple(int(s) for s in shape)):
        outs.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(list(reversed(outs))).to(data.dtype)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset: int = 0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(A, offset: int = 0):
    return torch.diag_embed(A, offset=offset)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", num_outputs=2)
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


# --- list-signature joins --------------------------------------------------
@register("concat", aliases=("Concat",))
def concat(*data, dim: int = 1):
    """The inputs joined along the existing axis ``dim``."""
    return torch.cat(data, dim=dim)


@register("stack")
def stack(*data, axis: int = 0):
    """The inputs joined along a new axis ``axis``."""
    return torch.stack(data, dim=axis)
