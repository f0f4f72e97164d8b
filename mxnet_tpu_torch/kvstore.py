"""KVStore: the key-value store for parameter synchronisation.

Counterpart of ``mxnet_tpu/kvstore.py``.  ``KVStoreLocal`` backs
``create('local' | 'device')``: a list of per-device values pushed under
one key is summed, then handed to the updater (or stored), and ``pull``
copies the stored value out.  ``KVStoreDist`` backs ``'nccl'``,
``'tpu'``, ``'dist_sync'``, ``'dist_device_sync'``, ``'dist'`` and
``'horovod'``; it stands for the JAX package's ``KVStoreTPU``: ``push``
sums the gradient over the ranks of the process group with
``torch.distributed.all_reduce`` (NCCL on the card, gloo on the CPU)
before the updater sees it, and ``rank``, ``num_workers`` and ``barrier``
are the group's.  Creating one joins the group (``parallel.initialize``)
when this process has not.  ``dist_async`` has no synchronous analogue and
raises; gradient compression waits (``ROADMAP.md``).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.ndarray import _wrap
from . import optimizer as opt

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDist", "create"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class KVStore:
    """Base KVStore interface: init, push, pull, the updater and the
    optimizer states."""

    def __init__(self):
        self._updater: Optional[Callable] = None
        self._compression_params = None

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """``pull`` when ``row_ids`` is None; sparse rows wait
        (``ROADMAP.md``)."""
        if row_ids is not None:
            raise MXNetError("row_sparse_pull of rows: sparse arrays are "
                             "not ported (ROADMAP.md)")
        return self.pull(key, out=out, priority=priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def set_gradient_compression(self, compression_params):
        raise MXNetError("gradient compression is not ported yet; it waits "
                         "(ROADMAP.md, queue 1, 'Data-parallel waits')")

    def set_optimizer(self, optimizer):
        """Install an optimizer as the updater."""
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    @property
    def type(self) -> str:
        return self._type

    def num_dead_node(self, node_id: int = 0, timeout: int = 5) -> int:
        """Unreachable workers: a store in one process has no peers."""
        return 0

    get_num_dead_node = num_dead_node

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


class KVStoreLocal(KVStore):
    """The store of one process: push sums a per-device list, then updates
    the stored value through the updater (or replaces it); pull copies it
    into the outputs."""

    def __init__(self, type_str="local"):
        super().__init__()
        self._type = type_str
        self._store: Dict = {}

    def _stored_value(self, key):
        if key not in self._store:
            raise MXNetError("key %r has not been init'd" % (key,))
        return self._store[key]

    def init(self, key, value):
        for k, v in zip(_as_list(key), _as_list(value)):
            self._store[k] = _wrap(v._data.detach().clone()) \
                if isinstance(v, NDArray) else v

    def _transform_grad(self, key, value):
        """Hook on each merged gradient before the updater or the store:
        the distributed store sums it over the ranks."""
        return value

    def push(self, key, value, priority=0):
        keys = _as_list(key)
        values = _as_list(value)
        if len(keys) == 1 and len(values) > 1:
            values = [value]
        for k, v in zip(keys, values):
            if isinstance(v, (list, tuple)):
                merged = v[0]
                for o in v[1:]:
                    merged = merged + o
                v = merged
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % str(k))
            v = self._transform_grad(k, v)
            if self._updater is not None:
                idx = int(k) if isinstance(k, str) and k.isdigit() else k
                self._updater(idx, v, self._store[k])
            else:
                self._store[k] = _wrap(v._data.detach().clone()) \
                    if isinstance(v, NDArray) else v

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each stored value into its outputs, in place (a Gluon
        parameter stays an autograd variable)."""
        for k, o in zip(_as_list(key), _as_list(out)):
            src = self._stored_value(k)._data
            for dst in _as_list(o):
                with torch.no_grad():
                    dst._data.copy_(src)
        return out


class KVStoreDist(KVStoreLocal):
    """The store over the process group: ``push`` sums each gradient over
    the ranks (``all_reduce``) before the updater; ``rank``,
    ``num_workers`` and ``barrier`` are the group's.  It stands for the JAX
    package's ``KVStoreTPU``, whose push sums over the mesh."""

    def __init__(self, type_str="nccl"):
        super().__init__(type_str)
        if not dist.is_initialized():
            from . import parallel
            parallel.initialize()

    def _group(self):
        from .parallel import get_mesh
        mesh = get_mesh()
        return mesh.group if mesh is not None else None

    def _transform_grad(self, key, value):
        if self.num_workers == 1:
            return value
        out = value._data.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self._group())
        return _wrap(out)

    @property
    def rank(self) -> int:
        return dist.get_rank(self._group())

    @property
    def num_workers(self) -> int:
        return dist.get_world_size(self._group())

    def barrier(self):
        dist.barrier(group=self._group())


def _maybe_init_distributed():
    """Join the group from the launcher's environment
    (``MXNET_TPU_COORDINATOR_ADDRESS`` and the rest), raising if that
    fails: going on in one process would train on 1/N of the data."""
    if "MXNET_TPU_COORDINATOR_ADDRESS" not in os.environ \
            or dist.is_initialized():
        return
    from . import parallel
    try:
        parallel.initialize()
    except MXNetError as e:
        raise MXNetError(
            "dist kvstore: joining the process group failed (%s) although "
            "MXNET_TPU_COORDINATOR_ADDRESS is set; call "
            "mx.parallel.initialize() first, or unset the distributed "
            "environment" % e) from e


def create(name="local") -> KVStore:
    """A KVStore: ``'local'``/``'device'`` in one process, ``'nccl'``,
    ``'tpu'``, ``'dist_sync'``, ``'dist_device_sync'``, ``'dist'`` and
    ``'horovod'`` over the process group; ``'dist_async'`` raises."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name_l = name.lower()
    if name_l in ("local", "local_allreduce_cpu", "local_allreduce_device",
                  "device"):
        return KVStoreLocal(name_l)
    if name_l in ("tpu", "nccl", "dist_sync", "dist_device_sync", "dist",
                  "horovod"):
        if name_l.startswith("dist"):
            _maybe_init_distributed()
        return KVStoreDist(name_l)
    if name_l == "dist_async":
        raise MXNetError(
            "dist_async has no synchronous data-parallel analogue; use "
            "'dist_sync'")
    raise MXNetError("unknown KVStore type %s" % name)
