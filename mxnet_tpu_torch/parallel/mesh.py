"""The device mesh: a 1-D data-parallel axis over a process group.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  There a mesh names the
axes of a grid of TPU cores that one program drives; here each card is
driven by a process of its own, and a mesh is the ``torch.distributed``
process group of those processes, one rank per card, along one axis,
``dp``.  Its ``size`` is the group's world size and its ``rank`` this
process's place on the axis, which is the order ``shard_batch`` and the
ZeRO shard layout follow.  Other axes (``tp``, ``sp``) wait
(``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch.distributed as dist

from ..base import MXNetError

__all__ = ["Mesh", "set_mesh", "get_mesh", "current_mesh", "default_mesh",
           "device_mesh"]


class Mesh:
    """A ``dp`` axis over a process group (the default group when
    ``group`` is None); ``shape`` maps the axis to its size, as a JAX
    mesh's does."""

    def __init__(self, group=None, axis_names=("dp",)):
        if not dist.is_initialized():
            raise MXNetError("a mesh needs torch.distributed: call "
                             "mx.parallel.initialize() first")
        self.group = group
        self.axis_names = tuple(axis_names)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    @property
    def shape(self):
        return {"dp": self.size}

    def __repr__(self):
        return "Mesh(dp=%d, rank=%d, backend=%s)" % (self.size, self.rank,
                                                     self.backend)


class _MeshState(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_STATE = _MeshState()


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install the mesh that ``kvstore('nccl')``, the Trainer and
    ``shard_batch`` use on this thread."""
    _STATE.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _STATE.mesh


class current_mesh:
    """Context manager scoping a mesh."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = _STATE.mesh
        _STATE.mesh = self._mesh
        return self._mesh

    def __exit__(self, *a):
        _STATE.mesh = self._prev
        return False


def device_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = ("dp",), devices=None) -> Mesh:
    """The ``dp`` mesh over every rank of the default process group.
    ``shape`` may only restate it, ``(world_size,)``; each process brings
    its own card, so ``devices`` is not taken."""
    axis_names = tuple(axis_names)
    if axis_names != ("dp",):
        raise MXNetError(
            "mesh axes %r: only a 1-D 'dp' axis is ported; the 'tp' and "
            "'sp' axes wait (ROADMAP.md, queue 1)" % (axis_names,))
    if devices is not None:
        raise MXNetError("device_mesh: a rank drives one card, its own; "
                         "the mesh is the process group, not a device list")
    mesh = Mesh(None, axis_names)
    if shape is not None and tuple(shape) != (mesh.size,):
        raise MXNetError("device_mesh%r: the process group has %d rank(s)"
                         % (tuple(shape), mesh.size))
    return mesh


def default_mesh() -> Mesh:
    """The installed mesh, or a fresh ``dp`` mesh over every rank."""
    m = get_mesh()
    if m is None:
        m = device_mesh()
        set_mesh(m)
    return m
