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
as on the JAX step's one sharded array (``ops/nn.py``).  Nothing in a step
reads a value back to the host, so a later change can capture it as a
CUDA graph; the loss comes back as a 0-d NDArray on the device.

The state is the JAX step's: per trainable parameter, in sorted-name
order, the optimizer's state leaves (the fp32 master first under
``multi_precision``), replicated or in the flat zero-padded layout of
which each rank holds its ``1/N`` slice; the step count starts at 1 and
the learning-rate schedule is read on every call.  Dropout draws from a
generator seeded for each step from ``mx.random`` (its masks are not the
JAX package's).  ``mirror``, ``donate_batch`` and ``grad_compression``,
``reshard`` and the checkpoint state wait (``ROADMAP.md``, queue 1,
"Data-parallel waits").
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import Context
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import _wrap
from ..ops.nn import cross_rank_batch_stats
from ..optimizer.optimizer import _f32, _leaves
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
        self._mp_written = {}   # slot -> (weight tensor, its version)
        mp = bool(getattr(optimizer, "multi_precision", False))
        for slot, i in enumerate(self._trainable):
            w = params[i].data()._data.detach()
            use_mp = mp and w.dtype in _HALF
            self._mp_slots.append(use_mp)
            wdata = w.float() if use_mp else w
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
                                     self._mesh).clone()
            self._opt_states[slot][0] = master
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

    def _dispatch(self, data, label, scan):
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
        if not scan:
            return _wrap(self._one_step(dval, lval, t0, lrs))
        losses = []
        for j in range(lead):
            d = tuple(None if v is None else v[j] for v in dval) if tupled \
                else dval[j]
            losses.append(self._one_step(d, lval[j], t0 + j, lrs))
        return _wrap(torch.stack(losses))

    def _one_step(self, dval, lval, t, lrs):
        mesh = self._mesh
        n = mesh.size if mesh is not None else 1
        args = [None if d is None else _wrap(d) for d in dval] \
            if isinstance(dval, tuple) else [_wrap(dval)]
        gen = torch.Generator(device=self._device())
        gen.manual_seed(_random.draw_seed() + (mesh.rank if mesh else 0))
        stats = cross_rank_batch_stats(mesh.group, n) if n > 1 \
            else contextlib.nullcontext()
        with autograd.record(), _random.generator_scope(gen), stats:
            out = self._net(*args)
            loss = self._loss(out, _wrap(lval))
            loss_val = loss._data.mean()
        weights = [self._params[i]._data._data for i in self._trainable]
        grads = torch.autograd.grad(loss_val, weights, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, weights)]
        loss_val = loss_val.detach()
        with torch.no_grad():
            self._update(weights, grads, t, lrs)
            if n > 1:
                loss_val = _sum(loss_val, mesh) / n
        return loss_val

    def _update(self, weights, grads, t, lrs):
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
            opt._step(ws, gs, slots, [lrs[s] for s in group],
                      opt._get_wds(group), [t] * len(group), True)
            if mp:
                for s, master in zip(group, ws):
                    weights[s].copy_(master)
                    self._note_written(s)
        for s in range(len(weights)):
            if not self._shard_slots[s]:
                continue
            new_w, new_st = zero_sharded_update(
                self._steps[s], weights[s], grads[s], self._opt_states[s], t,
                lrs[s], shape=self._shard_meta[s], mp=self._mp_slots[s],
                axis_size=self._shard_n, mesh=mesh, average=True)
            weights[s].copy_(new_w)
            self._opt_states[s] = new_st
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
