"""Data parallelism over ``torch.distributed``: the mesh, collectives and
the fused data-parallel train step.

Counterpart of ``mxnet_tpu/parallel/__init__.py``.  The JAX package drives
every core of a mesh from one program and lets XLA insert the collectives;
here one process drives each card, a mesh is their process group along
one ``dp`` axis, and the collectives are ``torch.distributed`` calls:
NCCL on the card, gloo only when the caller asks for the CPU.
``initialize`` joins the group from the same environment as the JAX
package's (``MXNET_TPU_COORDINATOR_ADDRESS``, ``MXNET_TPU_NUM_PROCESSES``,
``MXNET_TPU_PROCESS_ID``, ``MXNET_TPU_INIT_TIMEOUT``; the package joins at
import when the first is set), ``shard_batch`` gives each rank its rows of
a global batch and ``replicate`` broadcasts rank 0's value.  Ring
attention, pipelines, MoE, elastic re-formation, chaos and gradient
compression wait (``ROADMAP.md``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import _wrap
from .mesh import (  # noqa: F401
    Mesh, current_mesh, default_mesh, device_mesh, get_mesh, set_mesh,
)
from .collectives import (  # noqa: F401
    allreduce, all_gather, all_gather_unpad, flatten_pad, padded_size,
    pmean, psum, reduce_scatter, reduce_scatter_padded, unflatten,
    zero_sharded_update,
)
from .data_parallel import DataParallelStep  # noqa: F401

__all__ = [
    "Mesh", "current_mesh", "default_mesh", "device_mesh", "get_mesh",
    "set_mesh", "allreduce", "all_gather", "all_gather_unpad",
    "flatten_pad", "padded_size", "pmean", "psum", "reduce_scatter",
    "reduce_scatter_padded", "unflatten", "zero_sharded_update",
    "DataParallelStep", "shard_batch", "replicate", "initialize",
]


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               initialization_timeout=None, backend=None):
    """Join the process group (a no-op when this process has joined).

    Arguments default from the launcher's environment, as in the JAX
    package; ``MXNET_TPU_DIST_BACKEND`` may name the backend.  The backend
    is NCCL, one card a rank (``cuda:<rank mod cards>``), unless the
    caller asks for gloo or calls from a ``with mx.cpu():`` scope.  A
    failed join raises: nothing falls back to gloo or to one process."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("MXNET_TPU_COORDINATOR_ADDRESS")
    if num_processes is None and "MXNET_TPU_NUM_PROCESSES" in env:
        num_processes = int(env["MXNET_TPU_NUM_PROCESSES"])
    if process_id is None and "MXNET_TPU_PROCESS_ID" in env:
        process_id = int(env["MXNET_TPU_PROCESS_ID"])
    if initialization_timeout is None and "MXNET_TPU_INIT_TIMEOUT" in env:
        initialization_timeout = int(env["MXNET_TPU_INIT_TIMEOUT"])
    if backend is None:
        backend = env.get("MXNET_TPU_DIST_BACKEND") or (
            "gloo" if current_context().device_type == "cpu" else "nccl")
    if backend not in ("nccl", "gloo"):
        raise MXNetError("backend %r: the port joins over 'nccl' (the "
                         "card) or 'gloo' (the CPU)" % (backend,))
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    kw = {"backend": backend, "world_size": world, "rank": rank}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if coordinator_address is None:
        if world != 1:
            raise MXNetError("%d processes need a coordinator address "
                             "(MXNET_TPU_COORDINATOR_ADDRESS)" % world)
        # the world-size-1 case: one rank needs no network, so the group
        # rendezvous through an in-process store
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = coordinator_address if "://" in \
            coordinator_address else "tcp://" + coordinator_address
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise MXNetError("the NCCL backend needs a CUDA device and none "
                             "is available; pass backend='gloo' (or join "
                             "inside 'with mx.cpu():') for the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    try:
        dist.init_process_group(**kw)
    except Exception as e:
        raise MXNetError("torch.distributed failed to join the %s group "
                         "(rank %d of %d): %s" % (backend, rank, world, e)) \
            from e


def shard_batch(x, mesh: Optional[Mesh] = None, axis: str = "dp"):
    """This rank's rows of a global batch: rank ``r`` of ``N`` gets rows
    ``r * B / N`` to ``(r + 1) * B / N``, the shard order of the JAX
    package's ``dp`` sharding.  ``x`` itself without a mesh; a batch that
    the ranks do not divide evenly raises."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or x is None:
        return x
    if axis not in mesh.axis_names:
        raise MXNetError("the mesh has no axis %r" % (axis,))
    val = x._data if isinstance(x, NDArray) else x
    b = val.shape[0]
    if b % mesh.size:
        raise MXNetError("a batch of %d rows does not split evenly over %d "
                         "ranks" % (b, mesh.size))
    k = b // mesh.size
    out = val[mesh.rank * k:(mesh.rank + 1) * k]
    return _wrap(out) if isinstance(x, NDArray) else out


def replicate(x, mesh: Optional[Mesh] = None):
    """Rank 0's value of ``x`` on every rank (the parameter broadcast);
    ``x`` itself without a mesh or on one rank."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or mesh.size == 1:
        return x
    val = (x._data if isinstance(x, NDArray) else x).detach().clone()
    dist.broadcast(val, src=dist.get_global_rank(mesh.group, 0)
                   if mesh.group is not None else 0, group=mesh.group)
    return _wrap(val) if isinstance(x, NDArray) else val
