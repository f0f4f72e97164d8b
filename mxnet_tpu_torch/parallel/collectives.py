"""Collectives: the communication vocabulary, over ``torch.distributed``.

Counterpart of ``mxnet_tpu/parallel/collectives.py``.  There ``psum`` and
its kin are ``jax.lax`` collectives traced into one program over the
mesh's cores; here each rank is a process holding its own values, and
every collective is an eager ``torch.distributed`` call on the mesh's
process group (NCCL on the card, gloo on the CPU).  ``pmean`` sums and
then divides by the group's size, since gloo has no ``AVG``.

The ZeRO flat layout (``padded_size``, ``flatten_pad``, ``unflatten``) is
the JAX package's exactly: a leaf is flattened and zero-padded to a
multiple of the axis size, and rank ``r`` holds elements ``r * P / N`` to
``(r + 1) * P / N`` of it, the order of a ``dp``-sharded JAX array.
``zero_sharded_update`` is one weight's sharded optimizer update, shared
by ``DataParallelStep`` and the Trainer, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import _wrap
from .mesh import get_mesh

__all__ = ["psum", "pmean", "all_gather", "reduce_scatter", "allreduce",
           "flatten_pad", "unflatten", "padded_size",
           "reduce_scatter_padded", "all_gather_unpad",
           "zero_sharded_update"]


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _rewrap(val, like):
    return _wrap(val) if isinstance(like, NDArray) else val


def _mesh(mesh, axis_name):
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise MXNetError("no mesh: install one with parallel.set_mesh or "
                         "pass mesh=")
    if axis_name not in mesh.axis_names:
        raise MXNetError("the mesh has no axis %r" % (axis_name,))
    return mesh


def _sum(val, mesh):
    """A new tensor: ``val`` summed over the mesh's ranks."""
    out = val.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def psum(x, axis_name: str = "dp", mesh=None):
    """Sum of every rank's ``x`` (the KVStore's push and pull sum)."""
    return _rewrap(_sum(_unwrap(x), _mesh(mesh, axis_name)), x)


def pmean(x, axis_name: str = "dp", mesh=None):
    """Mean of every rank's ``x``: the sum, then divided by the size."""
    m = _mesh(mesh, axis_name)
    return _rewrap(_sum(_unwrap(x), m) / m.size, x)


def all_gather(x, axis_name: str = "dp", axis: int = 0, tiled: bool = True,
               mesh=None):
    """Every rank's ``x``, in rank order, concatenated along ``axis``
    (``tiled``) or stacked on a new leading axis."""
    m = _mesh(mesh, axis_name)
    val = _unwrap(x).detach()
    out = torch.empty(m.size * val.numel(), dtype=val.dtype,
                      device=val.device)
    dist.all_gather_into_tensor(out, val.contiguous(), group=m.group)
    out = out.view((m.size,) + tuple(val.shape))
    if not tiled:
        return _rewrap(out.movedim(0, axis), x)
    return _rewrap(torch.cat(list(out.unbind(0)), dim=axis), x)


def reduce_scatter(x, axis_name: str = "dp", scatter_dimension: int = 0,
                   mesh=None):
    """This rank's block of the sum of every rank's ``x``, the blocks
    split evenly along ``scatter_dimension`` in rank order."""
    m = _mesh(mesh, axis_name)
    val = _unwrap(x).detach().movedim(scatter_dimension, 0)
    if val.shape[0] % m.size:
        raise MXNetError("reduce_scatter: dimension %d of %d is not a "
                         "multiple of %d ranks" % (scatter_dimension,
                                                   val.shape[0], m.size))
    out = torch.empty((val.shape[0] // m.size,) + tuple(val.shape[1:]),
                      dtype=val.dtype, device=val.device)
    dist.reduce_scatter_tensor(out, val.contiguous(), op=dist.ReduceOp.SUM,
                               group=m.group)
    return _rewrap(out.movedim(0, scatter_dimension), x)


def allreduce(x, axis_name: str = "dp", mesh=None):
    """The gradient all-reduce: the sum of every rank's ``x``; ``x``
    itself without a mesh or on a mesh of one rank."""
    m = mesh if mesh is not None else get_mesh()
    if m is None or m.size == 1:
        return x
    return psum(x, axis_name, m)


# ---------------------------------------------------------------------------
# ZeRO-style flat shard layout (arxiv 2004.13336: weight-update sharding)
# ---------------------------------------------------------------------------

def padded_size(n: int, axis_size: int) -> int:
    """Smallest multiple of ``axis_size`` >= n (and >= axis_size, so a
    scalar leaf still gives every rank one element)."""
    return max(1, -(-int(n) // int(axis_size))) * int(axis_size)


def flatten_pad(x, axis_size: int):
    """Flatten to 1-D and zero-pad so the length divides ``axis_size``.
    The pad lanes are zero in the weight, its state and its gradient, so
    every elementwise update leaves the real lanes as they would be."""
    flat = _unwrap(x).reshape(-1)
    pad = padded_size(flat.shape[0], axis_size) - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return _rewrap(flat, x)


def unflatten(flat, shape):
    """Undo ``flatten_pad``: drop the pad lanes, restore ``shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    return _rewrap(_unwrap(flat)[:n].reshape(tuple(shape)), flat)


def local_shard(flat, mesh):
    """This rank's slice of a flat padded leaf."""
    val = _unwrap(flat)
    k = val.shape[0] // mesh.size
    return _rewrap(val[mesh.rank * k:(mesh.rank + 1) * k], flat)


def reduce_scatter_padded(x, axis_name: str = "dp", axis_size: int = None,
                          dtype=None, mesh=None):
    """This rank's 1/N slice of the sum over ranks of ``x`` flattened and
    zero-padded to a multiple of ``axis_size``, which must be the axis's
    size.  ``dtype`` casts the operand first: the sum then runs in it."""
    m = _mesh(mesh, axis_name)
    if axis_size is None or int(axis_size) != m.size:
        raise MXNetError("reduce_scatter_padded needs axis_size, the "
                         "mesh's %d ranks" % m.size)
    flat = flatten_pad(_unwrap(x), axis_size)
    if dtype is not None:
        flat = flat.to(dtype)
    return _rewrap(reduce_scatter(flat, axis_name, 0, m), x)


def all_gather_unpad(shard, shape, axis_name: str = "dp", mesh=None):
    """Inverse of ``reduce_scatter_padded``: gather every rank's flat
    shard, drop the padding, restore the natural ``shape``."""
    return unflatten(all_gather(shard, axis_name, 0, True, mesh), shape)


def zero_sharded_update(step_fn, w, g, state_leaves, t, lr, *, shape, mp,
                        axis_size, mesh=None, average=False, reduce=True,
                        scale=None):
    """One weight's ZeRO-sharded optimizer update (arxiv 2004.13336), the
    numerics of the JAX package's: the gradient, flattened and padded, is
    reduce-scattered (summed over ranks, then divided by their number
    with ``average``; with ``reduce=False`` it is the sum already, and this
    rank takes its slice, as a replicated gradient is sliced there),
    ``step_fn`` (an optimizer's ``make_step``) runs on
    this rank's 1/N shard, and the updated weight is all-gathered back in
    the working dtype.  Without ``mp`` the update runs in the weight's
    dtype (``lr`` rounded to it, as ``lr.astype(w.dtype)`` there) and the
    gradient is summed in it.  With ``mp`` the fp32 master, state leaf 0,
    is updated from the fp32 gradient and the half-width weight
    re-quantized from it before the gather.  State leaves arrive and leave
    as this rank's shards.  ``scale``, a device tensor, goes to ``step_fn``
    in place of ``t`` and ``lr`` (see ``Optimizer.make_step``).  Returns
    ``(new_weight, new_state_leaves)``."""
    from ..optimizer.optimizer import pin_update_dtypes
    m = _mesh(mesh, "dp")
    w, g = _unwrap(w), _unwrap(g)
    kw = {} if scale is None else {"scale": scale}

    def scatter(grad):
        if not reduce:
            return local_shard(flatten_pad(grad, axis_size), m)
        out = reduce_scatter_padded(grad, axis_size=axis_size, mesh=m)
        return out / m.size if average else out

    if mp:
        g32 = scatter(g.float())
        master, rest = state_leaves[0], list(state_leaves[1:])
        res = step_fn(master, g32, t, lr, *rest, **kw)
        new_master, new_rest = pin_update_dtypes(res, master, rest)
        half = all_gather_unpad(new_master.to(w.dtype), shape, mesh=m)
        return half, [new_master] + new_rest
    gg = scatter(g)
    wflat = local_shard(flatten_pad(w.detach(), axis_size), m)
    res = step_fn(wflat, gg, t, lr, *state_leaves, **kw)
    new_wflat, new_st = pin_update_dtypes(res, wflat, state_leaves)
    return all_gather_unpad(new_wflat, shape, mesh=m), new_st
