"""Gluon Trainer: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py``: ``step`` (rescale the
gradients by ``rescale_grad / batch_size``, reduce them through the
kvstore, update), ``allreduce_grads`` and ``update`` for the manual
split, ``learning_rate``/``set_learning_rate`` and ``save_states``/
``load_states``, whose files the JAX package's Trainer reads and writes
too.  The kvstore is chosen as there (``_init_kvstore``): ``'device'`` and
``'local'`` update through the store's updater in this process;
``'nccl'``, ``'dist_sync'`` and the other distributed stores sum each
gradient over the ranks of the process group, either in ``push`` before
the store's updater (``update_on_kvstore``, the default) or in
``allreduce_grads`` before the Trainer's own.  Where the JAX package fuses
every parameter's update into one jitted program (``_FusedUpdate``), the
update here runs the optimizer once over all the parameters with
``torch._foreach_*`` operations, in the jitted program's arithmetic, and
captures that as one CUDA graph per key (the JAX package's key: the
indices, the scalar hyperparameters, the weight decays, the weights'
shapes and dtypes; here also the storage the graph reads).  The graph
reads the gradient buffers in place (``'write'`` copies each gradient into
its buffer) and each step's rates from ``optimizer.DeviceScales``.  A rule
without ``make_step`` (every rule but SGD, Adam and AdamW) updates
eagerly, as the JAX package's Trainer falls back to its ``Updater``.
``shard_optimizer`` shards the optimizer state over a mesh of more than
one rank, through the same ``zero_sharded_update`` as
``DataParallelStep``; gradient compression waits (``ROADMAP.md``).

As in MXNet, ``step`` refuses a parameter whose gradient no ``backward``
has written since the last update (a stale gradient), unless
``ignore_stale_grad=True``, which skips such parameters.
"""
from __future__ import annotations

import os
import tempfile

import torch

from .. import kvstore as kvs
from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError
from ..cuda_graph import Captured, capturing, new_pool, storage_key
from ..cuda_graph import enabled as cuda_graph_enabled
from ..optimizer.optimizer import DeviceScales, _f32, _leaves
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


# optimizer attributes that no update graph reads: the clocks, and the
# rate, which reaches the graph through its device scales
_UNBAKED = ("num_update", "begin_num_update", "lr")


class _FusedUpdate:
    """Every parameter's update in one pass (the states stay the
    ``Updater``'s, so ``save_states`` writes what this updates), captured
    as one graph per key (:meth:`_captured`) where the rule has a pure
    step.  With ``shard_optimizer`` on a mesh of more than one rank, each
    weight's state lives as this rank's flat shards (``_sharded``, built
    from the updater's states at first use) and the update is
    ``zero_sharded_update``'s; ``materialize_states`` gathers the shards
    back into the updater's states."""

    def __init__(self, updater, shard_optimizer=False):
        self._updater = updater
        self._cache = {}
        self._pool = None
        if shard_optimizer not in (False, None, True, "auto"):
            raise ValueError("shard_optimizer must be True/False/'auto', "
                             "got %r" % (shard_optimizer,))
        self._shard_opt = bool(shard_optimizer)
        self._sharded = {}       # index -> this rank's flat state shards
        self._mesh = None

    def _shard_ready(self):
        """Sharding engages on a mesh of more than one rank, whose ranks
        all hold the same weights (each process's replica)."""
        if not self._shard_opt:
            return False
        if self._mesh is None:
            from ..parallel import get_mesh
            mesh = get_mesh()
            if mesh is None or "dp" not in mesh.axis_names \
                    or mesh.size <= 1:
                return False
            self._mesh = mesh
        return True

    def _sharded_leaves(self, i):
        from ..parallel.collectives import flatten_pad, local_shard
        got = self._sharded.get(i)
        if got is None:
            got = [local_shard(flatten_pad(l, self._mesh.size),
                               self._mesh).clone()
                   for l in _leaves(self._updater.states[i])]
            self._sharded[i] = got
        return got

    def materialize_states(self):
        """Gather every rank's shards back into the updater's states."""
        from ..parallel.collectives import all_gather_unpad
        for i, flat in self._sharded.items():
            for shell, fl in zip(_leaves(self._updater.states[i]),
                                 flat):
                with torch.no_grad():
                    shell.copy_(all_gather_unpad(fl, shell.shape,
                                                 mesh=self._mesh))

    def invalidate_sharded(self):
        self._sharded.clear()

    def _captured(self, indices, grads, weights):
        """The replicated update as one captured graph: the body is
        ``Updater._trainer_update`` (the same bits), and each step's rates
        reach it as :class:`DeviceScales` (``Optimizer._scale_table``),
        written before each replay.  False where the rule has no pure step
        (the caller updates eagerly)."""
        updater = self._updater
        optimizer = updater.optimizer
        if not optimizer._has_step or optimizer._in_order or capturing() \
                or not cuda_graph_enabled():
            # no pure step, inside another graph's body (which holds the
            # update in its own capture), or graphs disabled
            return False
        indices = list(indices)
        states = updater._states(indices, weights)
        values, index = optimizer._scale_table(indices, weights)
        fingerprint = tuple(sorted(
            (k, v) for k, v in vars(optimizer).items()
            if isinstance(v, (int, float, bool, str, type(None)))
            and k not in _UNBAKED))
        wds = tuple(optimizer._get_wds(indices))
        key = (tuple(indices), fingerprint, wds,
               tuple((tuple(w.shape), str(w._data.dtype)) for w in weights),
               tuple(index))
        storage = storage_key([t._data for t in weights + grads]
                              + [l for s in states for l in _leaves(s)])
        hit = self._cache.get(key)
        if hit is None or hit[1] != storage:
            telemetry.record_compile(
                "FusedUpdate[%x]" % id(self),
                {"indices": indices, "hyperparams": dict(fingerprint),
                 "wds": list(wds),
                 "weights": [{"shape": list(w.shape),
                              "dtype": str(w._data.dtype)}
                             for w in weights]})
            hit = self._cache[key] = (self._build(indices, grads, weights,
                                                  index), storage)
        hit[0]([torch.tensor(values, dtype=torch.float32)])
        return True

    def _build(self, indices, grads, weights, index):
        updater = self._updater

        def body(inputs):
            updater._trainer_update(indices, grads, weights,
                                    DeviceScales(inputs[0], index))
            return []
        device = weights[0]._data.device
        if self._pool is None:
            self._pool = new_pool(device)
        return Captured(body, [torch.empty(max(index) + 1,
                                           dtype=torch.float32,
                                           device=device)],
                        pool=self._pool)

    def __call__(self, indices, grads, weights, reduce):
        """Update ``weights`` from ``grads``; ``reduce``: the gradients
        are this rank's own, to be summed over the ranks (else they are
        the sum already).  False when the sharded update is not
        available (the caller updates otherwise)."""
        updater = self._updater
        if not self._shard_ready():
            if reduce:
                return False
            if not self._captured(indices, grads, weights):
                updater._trainer_update(indices, grads, weights)
            return True
        optimizer = updater.optimizer
        for i, w in zip(indices, weights):
            if i not in updater.states:
                updater.states[i] = optimizer.create_state_multi_precision(
                    i, w)
                updater.states_synced[i] = True
        try:
            steps = [optimizer.make_step(i) for i in indices]
        except NotImplementedError:
            # no pure step (NAG): the replicated update takes over
            self._shard_opt = False
            self.materialize_states()
            self.invalidate_sharded()
            return self(indices, grads, weights, reduce)
        from ..parallel.collectives import zero_sharded_update
        optimizer._update_count(list(indices))
        lrs = optimizer._get_lrs(list(indices))
        t = optimizer.num_update
        for i, step, g, w, lr in zip(indices, steps, grads, weights, lrs):
            mp = optimizer.multi_precision and optimizer._is_half(
                w._data.dtype)
            new_w, new_st = zero_sharded_update(
                step, w._data, g._data, self._sharded_leaves(i), t,
                _f32(lr), shape=tuple(w.shape), mp=mp,
                axis_size=self._mesh.size, mesh=self._mesh, reduce=reduce)
            with torch.no_grad():
                w._data.copy_(new_w)
            self._sharded[i] = new_st
        return True


class Trainer:
    """Optimizer driver over ``params`` (a ParameterDict, a dict or a list
    of Parameters; a dict is taken in sorted key order, as in the JAX
    package, so state indices agree between the two).

    ``kvstore``: ``'device'`` (default), ``'local'``, ``None``, a store
    name of :func:`kvstore.create` or a KVStore.  ``update_on_kvstore``:
    None (True with a store) updates through the store's updater; False
    reduces the gradients and updates here (``allreduce_grads`` and
    ``update`` may then be called apart).  ``donate_grads``: accepted as
    the JAX package's keyword, where it lets the jitted update consume the
    gradient buffers instead of copying them.  The captured update here
    reads the gradient buffers in place and copies nothing, with or
    without it, so it changes no arithmetic, and ``param.grad()`` stays
    readable after ``step`` either way.  ``shard_optimizer``: shard the
    optimizer state over a mesh of more than one rank."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, donate_grads=False,
                 shard_optimizer=False):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params)))
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
        if compression_params:
            raise MXNetError("gradient compression is not ported yet; it "
                             "waits (ROADMAP.md, queue 1, 'Data-parallel "
                             "waits')")
        self._params = list(params)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater = opt.get_updater(self._optimizer)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._donate_grads = bool(donate_grads)
        self._shard_optimizer = shard_optimizer
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._fused = None

    def _init_kvstore(self):
        """Pick and set up the kvstore, as the JAX package's Trainer."""
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if kvstore is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            if isinstance(kvstore, str):
                kvstore = kvs.create(kvstore)
            self._kvstore = kvstore
            self._update_on_kvstore = True if update_on_kvstore is None \
                else update_on_kvstore
            if self._update_on_kvstore:
                kvstore._set_updater(self._updater)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _distributed(self):
        return isinstance(self._kvstore, kvs.KVStoreDist) \
            and self._kvstore.num_workers > 1

    def allreduce_grads(self):
        """Sum every gradient over the ranks, for an update made apart
        (``update``); only without ``update_on_kvstore``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore and self._update_on_kvstore:
            raise AssertionError(
                "allreduce_grads() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` "
                "to False when creating trainer.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if not self._distributed():
            return
        from .. import parallel
        for param in self._params:
            if param.grad_req != "null":
                g = param.grad()
                with torch.no_grad():
                    g._data.copy_(parallel.psum(g._data))

    def step(self, batch_size, ignore_stale_grad=False):
        """One update from the gradients of the last ``backward``, each
        scaled by ``rescale_grad / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore and self._update_on_kvstore:
            self._update_on_store(ignore_stale_grad)
            return
        self._allreduce_grads()
        self._update(ignore_stale_grad, reduce=False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone (after ``allreduce_grads``); only without
        ``update_on_kvstore``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore and self._update_on_kvstore:
            raise AssertionError(
                "update() when parameters are updated on kvstore "
                "is not supported. Try setting `update_on_kvstore` "
                "to False when creating trainer.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad, reduce=False)

    def _fresh(self, ignore_stale_grad):
        """The parameters to update: every one with a gradient that a
        ``backward`` wrote since the last update; a stale one raises unless
        ``ignore_stale_grad``, which skips it."""
        out = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not param.data()._fresh_grad:
                if ignore_stale_grad:
                    continue
                raise UserWarning(
                    "Gradient of Parameter `%s` has not been updated by "
                    "backward since last `step`. This could mean a bug in "
                    "your model that made it only use a subset of the "
                    "Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient"
                    % param.name)
            out.append(i)
        return out

    def _fused_update(self, indices, reduce):
        if self._fused is None:
            self._fused = _FusedUpdate(self._updater, self._shard_optimizer)
        grads = [self._params[i].grad() for i in indices]
        weights = [self._params[i].data() for i in indices]
        return self._fused(indices, grads, weights, reduce)

    def _update_on_store(self, ignore_stale_grad):
        """The store's update: in one pass where no rank needs the others'
        gradients first (or the sharded update sums them itself), else
        push and pull each parameter (``push`` sums over the ranks)."""
        indices = self._fresh(ignore_stale_grad)
        if indices and not self._fused_update(indices, self._distributed()):
            store = self._kvstore
            for i in indices:
                param = self._params[i]
                if i not in store._store:
                    store.init(i, param.data())
                store.push(i, param.grad())
                store.pull(i, out=param.data())
        for i in indices:
            self._params[i].data()._fresh_grad = False

    def _update(self, ignore_stale_grad, reduce):
        indices = self._fresh(ignore_stale_grad)
        if indices:
            self._fused_update(indices, reduce)
        for i in indices:
            self._params[i].data()._fresh_grad = False

    def _sync_sharded_states(self, invalidate=False):
        if self._fused is None:
            return
        if invalidate:
            self._fused.invalidate_sharded()
        else:
            self._fused.materialize_states()

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname`` atomically (a
        temporary file, then ``os.replace``)."""
        self._sync_sharded_states()
        payload = self._updater.get_states(dump_optimizer=True)
        directory = os.path.dirname(os.path.abspath(fname))
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-states-")
        try:
            with os.fdopen(fd, "wb") as fout:
                fout.write(payload)
            os.replace(tmp, fname)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def load_states(self, fname):
        """Read a :meth:`save_states` file of either package."""
        self._sync_sharded_states(invalidate=True)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
