"""The data-parallel train step: forward, loss, backward, gradient
all-reduce and optimizer update in one call.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py``.  The JAX step
jits all of it into one XLA program over a mesh of cores, with the batch
sharded over ``dp`` and GSPMD inserting the gradient all-reduce.  Here one
process drives each card: ``__call__`` takes the global batch, keeps this
rank's rows (``shard_batch``), runs the forward and the loss in training
mode, takes the gradients of the mean loss over those rows with
``torch.autograd.grad`` (the parameters' gradient buffers are left alone,
as the JAX step leaves them), and then either sums them over the ranks and
divides by their number (one ``all_reduce`` a dtype) and updates every
replicated weight in place in the arithmetic of the optimizer's
``make_step``, or, with ``shard_optimizer``, runs each weight's
``zero_sharded_update``.  BatchNorm's statistics are the global batch's,
as on the JAX step's one sharded array (``ops/nn.py``).

Where the JAX step jits all of that once per cache key (``call`` or
``scan``, the data's and the label's shapes and dtypes), this step
captures it as one CUDA graph per key (``cuda_graph.Captured``): the
forward and the loss under ``record``, ``torch.autograd.grad``, the
all-reduce and the update.  The batch is copied into the graph's static
inputs.  The values that change from step to step are written into a
small device tensor before each replay, as the JAX step passes its rates
and step count traced: the learning rate of each slot and the step count,
folded on the host into each slot's update scale (``Optimizer.
_fused_scale``, in the jitted step's fp32 arithmetic), one entry for each
class of slots that share a rate multiplier and an update dtype.  The
optimizer states and the fp32 masters are written in place, so the
graph's addresses stay valid; a parameter whose tensor was replaced
(``reset_ctx``, ``cast``) is captured again, reported as a recompile.
Nothing in a step reads a value back to the host; the loss comes back as
a fresh 0-d NDArray on the device.  On the CPU each call runs the same
body on the same static buffers, without a graph.

The state is the JAX step's: per trainable parameter, in sorted-name
order, the optimizer's state leaves (the fp32 master first under
``multi_precision``), replicated or in the flat zero-padded layout of
which each rank holds its ``1/N`` slice; the step count starts at 1 and
the learning-rate schedule is read on every call.  Dropout draws from the
step's own generator, which each step (each replay) advances, seeded from
``mx.random`` at the first call and again after every ``mx.random.seed``,
as the JAX step draws a new key then (its masks are not the JAX
package's).  ``mirror``, ``donate_batch`` and ``grad_compression``,
``reshard`` and the checkpoint state wait (``ROADMAP.md``, queue 1,
"Data-parallel waits").
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import autograd, telemetry
from .. import random as _random
from ..base import MXNetError
from ..context import Context
from ..cuda_graph import Captured, new_pool, storage_key
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import _wrap
from ..ops.nn import cross_rank_batch_stats
from ..optimizer.optimizer import DeviceScales, _f32, _leaves
from .collectives import (_sum, flatten_pad, local_shard,
                          zero_sharded_update)
from .mesh import get_mesh

__all__ = ["DataParallelStep"]

_WAITS = "ROADMAP.md, queue 1, 'Data-parallel waits'"
_OFF = (None, False, 0, "", "0", "off")
_HALF = (torch.float16, torch.bfloat16)


def _waits(what):
    return MXNetError("%s is not ported yet; it waits (%s)" % (what, _WAITS))


class DataParallelStep:
    """A Gluon block, a loss and an optimizer as one data-parallel step.

    Usage::

        step = DataParallelStep(net, loss_fn, optimizer, mesh=mesh)
        for data, label in batches:
            loss = step(data, label)      # params updated in place

    The net must be initialized, its deferred shapes settled (one forward
    first).  ``data`` is the global batch, or a tuple of forward inputs
    (``None`` entries allowed); ``mesh=None`` takes the installed mesh, and
    none means one process.  ``shard_optimizer=True|False|"auto"`` turns on
    the ZeRO-sharded update (``"auto"``: on a mesh of more than one rank).
    ``donate`` is accepted: the update writes the weights in place."""

    def __init__(self, net, loss_fn, optimizer, mesh=None, donate=True,
                 mirror=None, donate_batch=False, shard_optimizer=False,
                 grad_compression=None):
        if mirror not in _OFF or os.environ.get(
                "MXNET_BACKWARD_DO_MIRROR", "") not in ("", "0"):
            raise _waits("the backward mirror (mirror=, "
                         "MXNET_BACKWARD_DO_MIRROR)")
        if donate_batch:
            raise _waits("donate_batch")
        if grad_compression not in _OFF:
            raise _waits("grad_compression")
        self._net = net
        self._loss = loss_fn
        self._opt = optimizer
        # the recompile detector's name; an earlier step with the same id
        # was collected, and its compiles are not this step's
        self._program = "DataParallelStep[%x]" % id(self)
        telemetry.forget_compiles(self._program)
        self._mesh = mesh if mesh is not None else get_mesh()
        self._shard_n = self._resolve_shard_optimizer(shard_optimizer)
        params = [p for _, p in sorted(net.collect_params().items())
                  if p._data is not None]
        self._params = params
        self._trainable = [i for i, p in enumerate(params)
                           if p.grad_req != "null"]
        # NAG has no make_step, in the JAX package too: it raises here
        self._steps = [optimizer.make_step(slot)
                       for slot in range(len(self._trainable))]
        self._opt_states, self._mp_slots = [], []
        self._shard_slots, self._shard_meta = [], []
        self._upd_dtypes = []   # the dtype each slot's update runs in
        self._mp_written = {}   # slot -> (weight tensor, its version)
        mp = bool(getattr(optimizer, "multi_precision", False))
        for slot, i in enumerate(self._trainable):
            w = params[i].data()._data.detach()
            use_mp = mp and w.dtype in _HALF
            self._mp_slots.append(use_mp)
            wdata = w.float() if use_mp else w
            self._upd_dtypes.append(wdata.dtype)
            self._shard_meta.append(tuple(wdata.shape))
            if self._shard_n:
                leaves = self._create_sharded_state(optimizer, slot, wdata)
                if leaves is not None:
                    self._shard_slots.append(True)
                    self._opt_states.append(leaves)
                    continue
            self._shard_slots.append(False)
            leaves = _leaves(optimizer.create_state(slot, _wrap(wdata)))
            self._opt_states.append([wdata] + leaves if use_mp else leaves)
        for slot in range(len(self._trainable)):
            if self._mp_slots[slot]:
                self._note_written(slot)
        self._t = optimizer.begin_num_update
        self._cache = {}        # key -> (Captured, the parameters' storage)
        self._pool = None
        self._gen = None
        self._rng_epoch = None

    # ------------------------------------------------------------------
    # ZeRO-style sharded weight update (arxiv 2004.13336)
    # ------------------------------------------------------------------
    def _resolve_shard_optimizer(self, knob):
        """The number of ranks the state is sharded over (0: replicated).
        ``"auto"`` shards on a mesh of more than one rank (the JAX
        package's heuristic; its tuned-table lookup is not ported)."""
        if knob in _OFF:
            return 0
        if knob not in (True, 1, "1", "on", "auto"):
            raise ValueError("shard_optimizer must be True/False/'auto', "
                             "got %r" % (knob,))
        mesh = self._mesh
        if mesh is None or "dp" not in mesh.axis_names:
            if knob == "auto":
                return 0
            import warnings
            warnings.warn("shard_optimizer=True needs a mesh with a 'dp' "
                          "axis; falling back to the replicated update")
            return 0
        if knob == "auto" and mesh.size <= 1:
            return 0
        return int(mesh.size)

    def _create_sharded_state(self, optimizer, slot, wdata):
        """Slot ``slot``'s state born as this rank's flat shards (the fp32
        master first under multi-precision), or None when a leaf is not
        elementwise, and the slot stays replicated."""
        wflat = local_shard(flatten_pad(wdata, self._shard_n),
                            self._mesh).clone()
        leaves = _leaves(optimizer.create_state_flat(slot, _wrap(wflat)))
        if any(tuple(l.shape) != tuple(wflat.shape) for l in leaves):
            return None
        return [wflat] + leaves if self._mp_slots[slot] else leaves

    def optimizer_state_bytes(self, per_chip=True):
        """Optimizer-state bytes: with ``per_chip`` what one rank holds
        (a sharded leaf ``padded_size / N`` elements), else the whole
        state (a sharded leaf at its padded size), as the JAX package
        counts them."""
        total = 0
        for slot, leaves in enumerate(self._opt_states):
            for l in leaves:
                n = l.numel() * l.element_size()
                if not per_chip and self._shard_slots[slot]:
                    n *= self._shard_n
                total += n
        return total

    def _note_written(self, slot):
        w = self._params[self._trainable[slot]]._data._data
        self._mp_written[slot] = (w, w._version)

    def _resync_masters(self):
        """A half-width weight changed from outside the step (``set_data``,
        ``load_parameters``) since the step wrote it: its fp32 master is
        made again from it, as the JAX step does."""
        for slot, i in enumerate(self._trainable):
            if not self._mp_slots[slot]:
                continue
            w = self._params[i]._data._data
            seen, version = self._mp_written[slot]
            if seen is w and version == w._version:
                continue
            master = w.detach().float()
            if self._shard_slots[slot]:
                master = local_shard(flatten_pad(master, self._shard_n),
                                     self._mesh)
            self._opt_states[slot][0].copy_(master)
            self._note_written(slot)

    # ------------------------------------------------------------------
    def reshard(self, mesh):
        raise _waits("reshard (elastic re-formation)")

    def checkpoint_state(self):
        raise _waits("checkpoint_state")

    def load_checkpoint_state(self, state):
        raise _waits("load_checkpoint_state")

    def __call__(self, data, label):
        return self._dispatch(data, label, scan=False)

    def scan_steps(self, data, label):
        """``k`` consecutive steps over the leading dimension of ``data``
        and ``label`` (``(k, batch, ...)``); returns the ``(k,)`` losses.
        The learning rate is read once for the window, at its last step's
        count, as the JAX package's scan reads it; the step count advances
        by one a step."""
        return self._dispatch(data, label, scan=True)

    def _device(self):
        return self._params[0]._data._data.device

    def _prep(self, x, scan):
        if x is None:
            return None
        if isinstance(x, NDArray):
            val = x._data
        else:
            val = _nd.array(x, ctx=Context.from_device(self._device()))._data
        mesh = self._mesh
        if mesh is None:
            return val
        from . import shard_batch
        if scan:
            return shard_batch(val.movedim(1, 0), mesh).movedim(0, 1)
        return shard_batch(val, mesh)

    def _run_eagerly(self, data, label):
        """One call's step run eagerly, op by op, on the same static
        buffers and the same device scales: what a replay is held to."""
        return self._dispatch(data, label, scan=False, eager=True)

    def _dispatch(self, data, label, scan, eager=False):
        tupled = isinstance(data, (tuple, list))
        dval = tuple(self._prep(d, scan) for d in data) if tupled \
            else self._prep(data, scan)
        lval = self._prep(label, scan)
        if scan:
            first = next(d for d in dval if d is not None) if tupled \
                else dval
            lead = first.shape[0]
        else:
            lead = 1
        t0 = self._t + 1
        self._t += lead
        # the optimizer's clock and the scheduled rate of every slot, read
        # per call (once a window for scan_steps)
        self._opt.num_update = max(self._opt.num_update, self._t)
        lrs = [_f32(v) for v in
               self._opt._get_lrs(list(range(len(self._trainable))))]
        self._resync_masters()
        self._reseed()
        index, reps = self._scale_classes()
        flat = (list(dval) if tupled else [dval]) + [lval]
        if scan:
            steps = [[None if v is None else v[j] for v in flat]
                     for j in range(lead)]
        else:
            steps = [flat]
        entry = self._entry(scan, tupled, dval, lval, index, steps[0])
        run = entry.run_eager if eager else entry
        losses = [run(step + [self._scale_values(reps, lrs, t0 + j)])[0]
                  for j, step in enumerate(steps)]
        return _wrap(torch.stack(losses) if scan else losses[0])

    def _reseed(self):
        """The step's generator, seeded at the first call and after every
        ``mx.random.seed`` (each rank its own stream)."""
        if self._gen is None:
            self._gen = torch.Generator(device=self._device())
        epoch = _random.seed_epoch()
        if epoch != self._rng_epoch:
            rank = self._mesh.rank if self._mesh is not None else 0
            self._gen.manual_seed(_random.draw_seed() + rank)
            self._rng_epoch = epoch

    def _scale_classes(self):
        """Each slot's entry in the step's device scales, and one slot of
        each entry: slots that share a rate multiplier and an update dtype
        share an entry."""
        opt = self._opt
        entries, index, reps = {}, [], []
        for slot, dtype in enumerate(self._upd_dtypes):
            k = (opt._multiplier_for(slot, opt.lr_mult, "lr_mult"), dtype)
            if k not in entries:
                entries[k] = len(reps)
                reps.append(slot)
            index.append(entries[k])
        return tuple(index), reps

    def _scale_values(self, reps, lrs, t):
        """The device scales' values for step ``t`` (a host tensor)."""
        return torch.tensor([self._opt._fused_scale(lrs[s], t,
                                                    self._upd_dtypes[s])
                             for s in reps], dtype=torch.float32)

    def _entry(self, scan, tupled, dval, lval, index, example):
        """The captured step of this call's key, made (and reported to the
        recompile detector) on a miss or after a parameter's tensor was
        replaced."""
        sig = lambda v: None if v is None else (tuple(v.shape), str(v.dtype))
        key = ("scan" if scan else "call",
               tuple(sig(d) for d in dval) if tupled else sig(dval),
               sig(lval), index)
        storage = storage_key([p._data._data for p in self._params])
        hit = self._cache.get(key)
        if hit is not None and hit[1] == storage:
            return hit[0]
        sig_d = lambda v: None if v is None else {"shape": list(v.shape),
                                                  "dtype": str(v.dtype)}
        telemetry.record_compile(
            self._program,
            {"mode": "scan" if scan else "call",
             "data": [sig_d(d) for d in dval] if tupled else sig_d(dval),
             "label": sig_d(lval)})
        device = self._device()
        if self._pool is None:
            self._pool = new_pool(device)
        n_entries = max(index) + 1 if index else 0
        scales = torch.empty(n_entries, dtype=torch.float32, device=device)

        def body(inputs):
            *data, label, values = inputs
            return [self._one_step(tuple(data) if tupled else data[0], label,
                                   DeviceScales(values, index))]
        gens = (self._gen,) if device.type == "cuda" else ()
        entry = Captured(body, example + [scales], pool=self._pool,
                         generators=gens)
        self._cache[key] = (entry, storage)
        return entry

    def _one_step(self, dval, lval, scales):
        mesh = self._mesh
        n = mesh.size if mesh is not None else 1
        args = [None if d is None else _wrap(d) for d in dval] \
            if isinstance(dval, tuple) else [_wrap(dval)]
        stats = cross_rank_batch_stats(mesh.group, n) if n > 1 \
            else contextlib.nullcontext()
        holders = [self._params[i]._data for i in self._trainable]
        weights = [h._data for h in holders]
        # the forward reads fresh leaves on the weights' storage: their
        # gradient nodes are made here, on this step's stream, whatever
        # graph a caller keeps alive around the parameters' own tensors
        # (a node made on the legacy default stream would make the
        # backward wait on that stream, which a capture cannot hold)
        leaves = [w.detach().requires_grad_() for w in weights]
        for h, leaf in zip(holders, leaves):
            h._data = leaf
        try:
            with autograd.record(), _random.generator_scope(self._gen), \
                    stats:
                out = self._net(*args)
                loss = self._loss(out, _wrap(lval))
                loss_val = loss._data.mean()
            grads = torch.autograd.grad(loss_val, leaves, allow_unused=True)
        finally:
            for h, w in zip(holders, weights):
                h._data = w
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, weights)]
        loss_val = loss_val.detach()
        with torch.no_grad():
            self._update(weights, grads, scales)
            if n > 1:
                loss_val = _sum(loss_val, mesh) / n
        return loss_val

    def _update(self, weights, grads, scales):
        mesh = self._mesh
        n = mesh.size if mesh is not None else 1
        opt = self._opt
        rep = [s for s in range(len(weights)) if not self._shard_slots[s]]
        if n > 1 and rep:
            _average([grads[s] for s in rep], mesh)
        for mp in (False, True):
            group = [s for s in rep if self._mp_slots[s] == mp]
            if not group:
                continue
            states = [self._opt_states[s][1:] if mp else self._opt_states[s]
                      for s in group]
            ws = [self._opt_states[s][0] if mp else weights[s]
                  for s in group]
            gs = [grads[s] for s in group]
            slots = [list(c) for c in zip(*states)] if states[0] else []
            opt._step(ws, gs, slots, None, opt._get_wds(group), None, True,
                      scales.pick(group))
            if mp:
                for s, master in zip(group, ws):
                    weights[s].copy_(master)
                    self._note_written(s)
        for s in range(len(weights)):
            if not self._shard_slots[s]:
                continue
            new_w, new_st = zero_sharded_update(
                self._steps[s], weights[s], grads[s], self._opt_states[s],
                None, None, shape=self._shard_meta[s], mp=self._mp_slots[s],
                axis_size=self._shard_n, mesh=mesh, average=True,
                scale=scales.value(scales.index[s], torch.float32))
            weights[s].copy_(new_w)
            # in place: a captured step reads and writes these addresses
            for leaf, new in zip(self._opt_states[s], new_st):
                leaf.copy_(new)
            if self._mp_slots[s]:
                self._note_written(s)


def _average(grads, mesh):
    """Each gradient, in place, summed over the ranks and divided by their
    number: one ``all_reduce`` a dtype over the gradients laid end to
    end."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = _sum(torch.cat([g.reshape(-1) for g in group]), mesh)
        flat /= mesh.size
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))
