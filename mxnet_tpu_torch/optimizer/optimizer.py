"""Optimizers and the updater that owns their states.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``, with all of its
sixteen rules (``SGD``, ``Signum``, ``FTML``, ``LBSGD``, ``DCASGD``,
``NAG``, ``SGLD``, ``Adam``, ``AdamW``, ``AdaGrad``, ``RMSProp``,
``AdaDelta``, ``Ftrl``, ``Adamax``, ``Nadam`` and ``Test``): the
``Optimizer`` base with its name registry, learning-rate and
weight-decay multipliers, update counting,
gradient preprocessing (rescale, then clip, then weight decay) and fp32
master weights for half-width weights (``multi_precision``), plus
``Updater``/``get_updater`` with state (de)serialization.

Where the JAX package writes each rule as a pure step function that
``jax.jit`` fuses over all parameters, an update here runs the rule once
over lists of tensors with ``torch._foreach_*`` operations, in place under
``torch.no_grad()``: one call covers every parameter the trainer updates.
The order of the floating-point operations is the JAX package's, so the
two agree to rounding.

The JAX package's ``Trainer.step`` and ``DataParallelStep`` run the same
rules jitted, where XLA's CPU backend computes some of them otherwise than
one operation after another: a float32 ``a * b + c`` is one fused
multiply-add (the first product of a sum of two), and a half-width value
that an fp32 operation reads keeps its fp32 precision.  ``fused=True``
(:meth:`Optimizer._step`) follows that arithmetic, and ``make_step``
returns it as a pure function of tensors, as the JAX package's does;
``pin_update_dtypes`` casts a step's results back to the carry dtypes.

A fused update reads the values that change from step to step (SGD's
``-lr``, Adam's bias-corrected ``lr_t``) as one scale a weight, computed
on the host in the jitted step's fp32 arithmetic (``_fused_scale``).  Given
as Python numbers, they are the operations' scalar arguments; given as
:class:`DeviceScales`, a small device tensor written before each step,
the operations read them there, so that a captured CUDA graph of the
update serves every step of a schedule (the JAX step passes its rates and
step count as traced values for the same reason).

Attribute names match the JAX package's, and ``Updater.get_states`` and
``set_states`` read and write the JAX package's pickle format, so a
``Trainer.save_states`` file of either package loads in the other.
"""
from __future__ import annotations

import importlib
import io
import math
import pickle
from typing import Dict

import numpy as onp
import torch

from ..context import cpu
from ..ndarray import NDArray
from ..ndarray.ndarray import _wrap

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG", "SGLD", "Adam",
           "AdamW", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "Test", "pin_update_dtypes", "DeviceScales"]


def pin_update_dtypes(res, weight, state_leaves):
    """Cast a ``make_step`` result back to the carry dtypes: the new
    weight to ``weight``'s and each new state to its leaf's.  Returns
    ``(new_weight, new_state_list)``."""
    new_w = res[0].to(weight.dtype)
    new_s = [r.to(s.dtype) if isinstance(r, torch.Tensor) else r
             for r, s in zip(res[1:], state_leaves)]
    return new_w, new_s


class Optimizer:
    """Base optimizer: rescale_grad, clip_gradient, learning_rate,
    lr_scheduler, wd, per-parameter lr/wd multipliers (from the Gluon
    parameters in ``param_dict``, else by index, else by name in
    ``param_idx2name``) and multi_precision."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.lr, self.wd = learning_rate, wd
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.aggregate_num = 0
        self.sym_info = ()
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.lr_mult, self.wd_mult = {}, {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        if not isinstance(klass, type):
            raise TypeError("register takes a class")
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- states ---------------------------------------------------------
    def create_state(self, index, weight):
        """Auxiliary state of one weight: None, an NDArray or a tuple."""
        return None

    @staticmethod
    def _is_half(dtype):
        return dtype in (torch.float16, torch.bfloat16)

    def create_state_flat(self, index, weight):
        """State of a weight given in the flat zero-padded shard layout of
        the ZeRO-sharded update (a 1-D tensor): every leaf must have that
        flat shape, so that each rank holds and updates its slice.  The
        elementwise rules here create it as :meth:`create_state` does; a
        caller keeps a weight whose leaves are not flat replicated."""
        return self.create_state(index, weight)

    def create_state_multi_precision(self, index, weight):
        """Half-width weights get an fp32 master copy as state leaf 0."""
        if self.multi_precision and self._is_half(weight._data.dtype):
            master = _wrap(weight._data.detach().float())
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- rates ----------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can mutate "
                              "the value of the learning rate of the optimizer "
                              "only when the LRScheduler of the optimizer is "
                              "undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-name weight-decay multipliers: names in ``param_idx2name``
        that end in neither ``_weight`` nor ``_gamma`` get 0.  A Gluon
        parameter's own ``wd_mult`` (``param_dict``) takes precedence."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, indices):
        """Advance each weight's update clock; ``num_update`` follows the
        most-updated weight (it drives the lr schedule)."""
        counts = self._index_update_count
        for idx in indices:
            counts[idx] = counts.get(idx, self.begin_num_update) + 1
            if counts[idx] > self.num_update:
                self.num_update = counts[idx]

    def _multiplier_for(self, index, mult_table, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in mult_table:
            return mult_table[index]
        name = self.idx2name.get(index)
        return mult_table.get(name, 1.0) if name is not None else 1.0

    def _get_lrs(self, indices):
        base = self.learning_rate
        return [base * self._multiplier_for(i, self.lr_mult, "lr_mult")
                for i in indices]

    def _get_wds(self, indices):
        return [self.wd * self._multiplier_for(i, self.wd_mult, "wd_mult")
                for i in indices]

    def make_step(self, index):
        """A pure update ``fn(w, g, t, lr, *states) -> (w', *states')`` of
        weight ``index`` on tensors, in the arithmetic of the JAX
        package's jitted step (``fused``, see :meth:`_step`): ``t`` is the
        step count (an int, 1 at the first update) and ``lr`` the learning
        rate (a float, rounded to fp32 and then to ``w``'s dtype as the JAX
        step rounds its fp32 rate).  ``scale=``, a 0-d fp32 device tensor
        holding :meth:`_fused_scale` of ``(lr, t, w.dtype)``, replaces
        ``t`` and ``lr``: the update then reads it on the device.  ``w``
        and the states are left as they are; the results may need
        :func:`pin_update_dtypes`.  Rules without one (NAG, as in the JAX
        package) raise ``NotImplementedError``."""
        if not self._has_step:
            raise NotImplementedError(
                "%s has no jit-pure step; Trainer will update eagerly"
                % type(self).__name__)
        wd = self._get_wds([index])[0]

        def step(w, g, t, lr, *states, scale=None):
            new = [w.detach().clone()] + [s.detach().clone() for s in states]
            with torch.no_grad():
                if scale is None:
                    self._step(new[:1], [g.detach()], [[s] for s in new[1:]],
                               [_f32(lr)], [wd], [int(t)], True)
                else:
                    self._step(new[:1], [g.detach()], [[s] for s in new[1:]],
                               None, [wd], None, True,
                               DeviceScales(scale.reshape(1), [0]))
            return tuple(new)
        return step

    _has_step = False
    # the rule reads host state that each weight's update advances (Nadam's
    # momentum schedule, LBSGD's clock): weights update one at a time
    _in_order = False

    # -- updates --------------------------------------------------------
    def update(self, index, weight, grad, state):
        """Update one weight (or, given lists, several) with its state, as
        the JAX package's ``Updater`` does: one eager operation after
        another."""
        indices, weights, grads, states = _as_lists(index, weight, grad,
                                                    state)
        if self._in_order and len(indices) > 1:
            for one in zip(indices, weights, grads, states):
                self.update(*one)
            return
        self._update_count(indices)
        self._run(indices, [w._data for w in weights],
                  [g._data for g in grads], states, False)

    def update_multi_precision(self, index, weight, grad, state):
        """As :meth:`update`; a half-width weight under ``multi_precision``
        is updated through its fp32 master (state leaf 0) and then set to
        the master's value."""
        self._update_multi_precision(index, weight, grad, state, False)

    def _update_multi_precision(self, index, weight, grad, state, fused,
                                scales=None):
        """:meth:`update_multi_precision`; ``fused``: as the JAX package's
        ``Trainer.step`` updates, through the optimizer's jitted step (see
        :meth:`_step`).  A rule without one (``_has_step`` false) updates
        eagerly there too, as the JAX package's Trainer falls back to its
        ``Updater``; a rule whose host state advances weight by weight
        (``_in_order``) updates one weight after another, in index
        order.  ``scales`` (fused, a rule with a step): the rates as
        :class:`DeviceScales`, one entry index a weight, from
        :meth:`_scale_table`, which advanced the clocks already (the
        update the Trainer captures)."""
        indices, weights, grads, states = _as_lists(index, weight, grad,
                                                    state)
        if self._in_order and len(indices) > 1:
            for one in zip(indices, weights, grads, states):
                self._update_multi_precision(*one, fused)
            return
        fused = fused and self._has_step
        if scales is None:
            self._update_count(indices)
        half = [self.multi_precision and self._is_half(w._data.dtype)
                for w in weights]
        full = [k for k, h in enumerate(half) if not h]
        if full:
            self._run([indices[k] for k in full],
                      [weights[k]._data for k in full],
                      [grads[k]._data for k in full],
                      [states[k] for k in full], fused,
                      scales and scales.pick(full))
        mp = [k for k, h in enumerate(half) if h]
        if mp:
            masters = [states[k][0]._data for k in mp]
            # the jitted step widens the gradient itself
            self._run([indices[k] for k in mp], masters,
                      [grads[k]._data if fused else grads[k]._data.float()
                       for k in mp], [states[k][1] for k in mp], fused,
                      scales and scales.pick(mp))
            with torch.no_grad():
                for k, m in zip(mp, masters):
                    weights[k]._data.copy_(m)

    def _run(self, indices, ws, gs, states, fused, scales=None):
        leaves = [_leaves(s) for s in states]
        slots = [list(col) for col in zip(*leaves)] if leaves and leaves[0] \
            else []
        if scales is not None:
            with torch.no_grad():
                self._step(ws, gs, slots, None, self._get_wds(indices), None,
                           True, scales)
            return
        counts = [self._index_update_count[i] for i in indices]
        lrs = self._get_lrs(indices)
        if fused:
            # the jitted step takes its rates as one fp32 vector
            lrs = [_f32(lr) for lr in lrs]
        with torch.no_grad():
            self._step(ws, gs, slots, lrs, self._get_wds(indices), counts,
                       fused)

    def _fused_scale(self, lr, t, dtype):
        """The one value of a fused update that changes from step to step,
        for a weight of ``dtype`` at rate ``lr`` (fp32) and step ``t``, as
        a Python float: what the update multiplies by."""
        raise NotImplementedError

    def _scale_table(self, indices, weights):
        """Advance the clocks of ``indices`` and return the rates of their
        fused update as ``(values, index)`` for :class:`DeviceScales`: one
        :meth:`_fused_scale` for each distinct ``(rate, step count, update
        dtype)`` (fp32 for a half-width weight under ``multi_precision``),
        and the entry each weight reads."""
        self._update_count(indices)
        lrs = [_f32(lr) for lr in self._get_lrs(indices)]
        entries, index, values = {}, [], []
        for i, lr, w in zip(indices, lrs, weights):
            dtype = torch.float32 if self.multi_precision \
                and self._is_half(w._data.dtype) else w._data.dtype
            k = (lr, self._index_update_count[i], dtype)
            if k not in entries:
                entries[k] = len(values)
                values.append(self._fused_scale(*k))
            index.append(entries[k])
        return values, index

    def _fused_scales(self, lrs, counts, ws):
        """:meth:`_fused_scale` of each weight of ``ws``."""
        memo = {}
        for lr, t, w in zip(lrs, counts, ws):
            if (lr, t, w.dtype) not in memo:
                memo[lr, t, w.dtype] = self._fused_scale(lr, t, w.dtype)
        return [memo[lr, t, w.dtype] for lr, t, w in zip(lrs, counts, ws)]

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        """Update the weight tensors ``ws`` and the state tensors (one list
        per state slot) in place.

        Every hyperparameter is rounded to its weight's dtype before it
        meets a tensor, and every operation rounds in that dtype, as the
        JAX package's weak-typed Python floats make its bf16 updates do.
        ``fused`` (``Trainer.step``, ``make_step``) takes the arithmetic of
        the JAX package's jitted step instead: fp32 ``a * b + c`` rounded
        once (:func:`_muladd`), and Adam's step as :meth:`Adam._step` says;
        an fp32 weight (a master) may then come with a half-width gradient,
        which the step widens, as the jitted step does.  ``scales`` (fused
        only; :meth:`_fused_scales` of ``lrs`` and ``counts`` when None) may
        be :class:`DeviceScales`, and ``lrs`` and ``counts`` None."""
        raise NotImplementedError

    def _preprocess(self, gs, ws, wds, fused=False):
        """New gradient tensors ``g * rescale_grad``, clipped to
        ``clip_gradient``, plus ``wd * w`` where ``wd`` is not 0.  With
        ``fused`` an fp32 ``g * rescale_grad + wd * w`` is one fused
        multiply-add (``wd * w + g`` after a clip), as the jitted step's."""
        if fused:
            return self._preprocess_fused(gs, ws, wds)
        g = torch._foreach_mul(gs, _scalars(self.rescale_grad, gs))
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, _scalars(-self.clip_gradient, g))
            torch._foreach_clamp_max_(g, _scalars(self.clip_gradient, g))
        decay = [k for k, wd in enumerate(wds) if wd]
        if decay:
            dws = [ws[k] for k in decay]
            torch._foreach_add_([g[k] for k in decay], torch._foreach_mul(
                dws, _rounded([wds[k] for k in decay], dws)))
        return g

    def _preprocess_fused(self, gs, ws, wds):
        # a half-width gradient of an fp32 weight (the master's) is widened
        # here, as the jitted step widens it inside the update; there XLA
        # fuses ``wd * w`` into the multiply-add instead of ``g * rescale``
        widened = [g.dtype != w.dtype for g, w in zip(gs, ws)]
        gs = [g.to(w.dtype) if wide else g
              for g, w, wide in zip(gs, ws, widened)]
        clip = self.clip_gradient is not None
        out = [None] * len(gs)
        for group in _width_groups(gs):
            decay = [] if clip else [k for k in group
                                     if wds[k] and not widened[k]]
            if decay:
                dws = _pick(ws, decay)
                wdw = torch._foreach_mul(dws, _rounded(_pick(wds, decay),
                                                       dws))
                for k, v in zip(decay, _muladd_all(_pick(gs, decay),
                                                   self.rescale_grad, wdw)):
                    out[k] = v
            rest = [k for k in group if out[k] is None]
            if not rest:
                continue
            g = torch._foreach_mul(_pick(gs, rest),
                                   _scalars(self.rescale_grad,
                                            _pick(gs, rest)))
            if clip:
                torch._foreach_clamp_min_(g, _scalars(-self.clip_gradient, g))
                torch._foreach_clamp_max_(g, _scalars(self.clip_gradient, g))
            for k, v in zip(rest, g):
                out[k] = _muladd(ws[k], wds[k], v) if wds[k] else v
        return out

    def __getstate__(self):
        # the Gluon parameters hold device tensors; whoever loads the
        # states sets its own (Trainer.load_states does)
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)


register = Optimizer.register
create = Optimizer.create_optimizer


def _as_lists(index, weight, grad, state):
    if isinstance(index, (list, tuple)):
        return list(index), list(weight), list(grad), list(state)
    return [index], [weight], [grad], [state]


def _leaves(state):
    """The tensors of a state (an NDArray, None or nested tuples of them,
    an fp32 master first), in order."""
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state._data]
    return [t for s in state for t in _leaves(s)]


def _zeros_like(weight: NDArray) -> NDArray:
    return _wrap(torch.zeros_like(weight._data.detach()))


def _in_dtype(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def _rounded(values, tensors):
    """Each value rounded to its tensor's dtype, as the ``scalars``
    argument of a ``torch._foreach_*`` op: one float where they all agree,
    so that one launch covers as many tensors as a scalar allows."""
    rounded = {}
    for v, t in zip(values, tensors):
        if (v, t.dtype) not in rounded:
            rounded[v, t.dtype] = _in_dtype(v, t.dtype)
    out = [rounded[v, t.dtype] for v, t in zip(values, tensors)]
    return out[0] if len(set(out)) == 1 else out


def _scalars(value, tensors):
    """``value`` rounded to each tensor's dtype (see :func:`_rounded`)."""
    return _rounded([value] * len(tensors), tensors)


def _f32(value):
    """``value`` rounded to fp32, as a Python float."""
    return float(onp.float32(value))


def _muladd(a, scale, c):
    """``a * scale + c`` (``scale`` a float) rounded once for fp32 tensors,
    as XLA's CPU backend contracts it into a fused multiply-add (torch's
    ``add`` with ``alpha`` is one); one operation after another, each
    rounded, for half-width tensors, which XLA computes that way."""
    if a.dtype == torch.float32:
        return torch.add(c, a, alpha=_f32(scale))
    return a * _in_dtype(scale, a.dtype) + c


def _muladd_all(tensors, scale, addends):
    """:func:`_muladd` of every tensor (one width class) by one ``scale``
    with its addend, in one multi-tensor operation."""
    if tensors[0].dtype == torch.float32:
        return torch._foreach_add(addends, tensors, alpha=_f32(scale))
    return torch._foreach_add(
        torch._foreach_mul(tensors, _scalars(scale, tensors)), addends)


def _add_scaled_(ws, g, scales):
    """``w += scale * g`` for every tensor of one width class, a fused
    multiply-add in fp32 (one launch where every scale agrees; with
    :class:`DeviceScales` ``addcmul``, one a tensor), one rounding after
    another in half width.  The scales are values of the weights' dtype."""
    if ws[0].dtype != torch.float32:
        torch._foreach_add_(ws, _scaled(g, scales))
    elif isinstance(scales, DeviceScales):
        for k, (w, gg) in enumerate(zip(ws, g)):
            w.addcmul_(gg, scales.value(scales.index[k], torch.float32))
    elif len(set(scales)) == 1:
        torch._foreach_add_(ws, g, alpha=scales[0])
    else:
        for w, gg, sc in zip(ws, g, scales):
            w.add_(gg, alpha=sc)


def _width_groups(tensors):
    """Indices of the fp32 tensors and of the others, each non-empty."""
    full = [k for k, t in enumerate(tensors) if t.dtype == torch.float32]
    half = [k for k, t in enumerate(tensors) if t.dtype != torch.float32]
    return [k for k in (full, half) if k]


def _pick(items, indices):
    if isinstance(items, DeviceScales):
        return items.pick(indices)
    return [items[k] for k in indices]


def _one_or_list(values):
    """One float where every value agrees (one launch covers as many
    tensors as a scalar allows), else the list."""
    return values[0] if len(set(values)) == 1 else values


class DeviceScales:
    """The per-step scales of a fused update, read from a device tensor.

    ``values`` is a 1-D fp32 tensor on the weights' device, written on the
    host before each step; ``index[k]`` is the entry that weight ``k`` of
    the update reads.  Each entry holds a value of the dtype it multiplies
    (a bf16 SGD rate is bf16-exact), so reading it in that dtype is exact,
    and weights that read one entry share one multi-tensor operation."""

    def __init__(self, values, index):
        self.values = values
        self.index = list(index)
        self._cast = {}

    def pick(self, positions):
        sub = DeviceScales(self.values, [self.index[k] for k in positions])
        sub._cast = self._cast
        return sub

    def value(self, j, dtype):
        """Entry ``j`` as a 0-d tensor of ``dtype``."""
        if (j, dtype) not in self._cast:
            v = self.values[j]
            self._cast[j, dtype] = v if v.dtype == dtype else v.to(dtype)
        return self._cast[j, dtype]

    def groups(self):
        """``(entry, positions)`` of each entry read: the positions of the
        weights that read it."""
        out = {}
        for k, j in enumerate(self.index):
            out.setdefault(j, []).append(k)
        return out.items()


def _scaled(tensors, scales):
    """Each tensor times its scale (floats, or :class:`DeviceScales`)."""
    if not isinstance(scales, DeviceScales):
        return torch._foreach_mul(tensors, _one_or_list(scales))
    out = [None] * len(tensors)
    for j, ks in scales.groups():
        part = torch._foreach_mul(_pick(tensors, ks),
                                  scales.value(j, tensors[ks[0]].dtype))
        for k, v in zip(ks, part):
            out[k] = v
    return out


def _pow32(base, t):
    """``base ** t`` in fp32 as the jitted step computes it (``powf``)."""
    return onp.power(onp.float32(base), onp.float32(t))


def _sgd_step(ws, g, lrs):
    torch._foreach_add_(ws, torch._foreach_mul(
        g, _rounded([-lr for lr in lrs], ws)))


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``m = momentum * m - lr * g``,
    ``w = w + m`` (``w = w - lr * g`` without momentum); the state is the
    momentum buffer, or None when momentum is 0."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    _has_step = True

    def _fused_scale(self, lr, t, dtype):
        return _in_dtype(-lr, dtype)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g = self._preprocess(gs, ws, wds, fused)
        if fused:
            if scales is None:
                scales = self._fused_scales(lrs, counts, ws)
            for k in _width_groups(ws):
                self._jitted(_pick(ws, k), _pick(g, k),
                             [_pick(s, k) for s in slots], _pick(scales, k))
            return
        if not slots:
            _sgd_step(ws, g, lrs)
            return
        (moms,) = slots
        torch._foreach_mul_(moms, _scalars(self.momentum, ws))
        torch._foreach_sub_(moms, torch._foreach_mul(g, _rounded(lrs, ws)))
        torch._foreach_add_(ws, moms)

    def _jitted(self, ws, g, slots, scales):
        """One width class: ``w - lr * g`` and ``momentum * m - lr * g``
        each one fused multiply-add in fp32 (``scales``: ``-lr`` in the
        weights' dtype)."""
        if not slots:
            _add_scaled_(ws, g, scales)
            return
        (moms,) = slots
        step = _scaled(g, scales)
        torch._foreach_copy_(moms, _muladd_all(moms, self.momentum, step))
        torch._foreach_add_(ws, moms)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD: ``m = momentum * m + g``,
    ``w = w - lr * (g + momentum * m)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g = self._preprocess(gs, ws, wds)
        if not slots:
            _sgd_step(ws, g, lrs)
            return
        (moms,) = slots
        mom = _scalars(self.momentum, ws)
        torch._foreach_mul_(moms, mom)
        torch._foreach_add_(moms, g)
        step = torch._foreach_mul(moms, mom)
        torch._foreach_add_(step, g)
        torch._foreach_mul_(step, _rounded(lrs, ws))
        torch._foreach_sub_(ws, step)


def _fused_lr_t(lr, t, b1, b2, dtype):
    """Adam's step size as the JAX package's jitted step computes it, as
    a Python float: lr (an fp32 value) rounded to the weight's dtype,
    times ``sqrt(1 - b2^t) / (1 - b1^t)`` in fp32 (its step count is a
    traced int32, which makes the bias correction fp32)."""
    one = onp.float32(1.0)
    lr = onp.float32(_in_dtype(lr, dtype))
    c2 = one - _pow32(b2, t)
    c1 = one - _pow32(b1, t)
    return float(lr * onp.sqrt(c2) / c1)


@register
class Adam(Optimizer):
    """Adam with bias correction folded into the step size:
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``,
    ``w = w - lr_t * m / (sqrt(v) + epsilon)``; the state is (m, v).

    The moments and ``sqrt(v)`` are computed in the weight's dtype.  The
    rest follows the JAX package's two paths, which differ for a
    half-width weight without ``multi_precision``: its ``Updater`` (and
    ``update``) computes ``lr_t`` in Python and every operation in the
    weight's dtype; its ``Trainer.step`` (``fused``) jits the step, where
    ``lr_t`` is fp32, so ``sqrt(v) + epsilon``, the step and ``w`` minus
    it are fp32 and the new weight is rounded once to its dtype
    (``pin_update_dtypes``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    _has_step = True

    def _fused_scale(self, lr, t, dtype):
        return _fused_lr_t(lr, t, self.beta1, self.beta2, dtype)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        b1, b2 = self.beta1, self.beta2
        g = self._preprocess(gs, ws, wds, fused)
        means, variances = slots
        if fused:
            if scales is None:
                scales = self._fused_scales(lrs, counts, ws)
            for k in _width_groups(ws):
                self._jitted(_pick(ws, k), _pick(g, k), _pick(means, k),
                             _pick(variances, k), _pick(scales, k))
            return
        torch._foreach_mul_(means, _scalars(b1, ws))
        torch._foreach_add_(means, torch._foreach_mul(g, _scalars(1 - b1,
                                                                  ws)))
        sq = torch._foreach_mul(g, _scalars(1 - b2, ws))
        torch._foreach_mul_(sq, g)
        torch._foreach_mul_(variances, _scalars(b2, ws))
        torch._foreach_add_(variances, sq)
        den = torch._foreach_sqrt(variances)
        lr_ts = _rounded([lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
                          for lr, t in zip(lrs, counts)], ws)
        torch._foreach_add_(den, _scalars(self.epsilon, ws))
        step = torch._foreach_mul(means, lr_ts)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(ws, step)

    def _jitted(self, ws, g, means, variances, scales):
        """One width class in the jitted step's arithmetic (``scales``:
        each weight's ``lr_t``).  fp32: the two
        moments each one fused multiply-add.  Half width: each operation
        rounds in the weight's dtype, but the fp32 step reads the new mean
        before its rounding (the sum of its two rounded products).  Then,
        in fp32, ``lr_t * m / (sqrt(v) + epsilon)`` with ``sqrt(v)``
        rounded to the weight's dtype, and ``w`` minus it rounded once."""
        b1, b2 = self.beta1, self.beta2
        full = ws[0].dtype == torch.float32
        gm = torch._foreach_mul(g, _scalars(1 - b1, ws))
        if full:
            m32 = new_m = _muladd_all(means, b1, gm)
        else:
            mb = torch._foreach_mul(means, _scalars(b1, ws))
            m32 = torch._foreach_add([x.float() for x in mb],
                                     [x.float() for x in gm])
            new_m = [x.to(w.dtype) for x, w in zip(m32, ws)]
        gv = torch._foreach_mul(g, _scalars(1 - b2, ws))
        torch._foreach_mul_(gv, g)
        new_v = _muladd_all(variances, b2, gv)
        torch._foreach_copy_(means, new_m)
        torch._foreach_copy_(variances, new_v)
        den = [d.float() for d in torch._foreach_sqrt(variances)]
        torch._foreach_add_(den, self.epsilon)
        step = _scaled(m32, scales)
        torch._foreach_div_(step, den)
        if full:
            torch._foreach_sub_(ws, step)
            return
        new = [w.float() for w in ws]
        torch._foreach_sub_(new, step)
        torch._foreach_copy_(ws, new)


# ---------------------------------------------------------------------------
# The other rules.  Each is written as the JAX package's eager ``update``
# computes it, one operation after another in the weight's dtype, every
# Python number rounded to that dtype first (``_smul``/``_sadd``); AdamW
# alone has a jitted step, the others update eagerly in ``Trainer.step``
# too and raise in ``make_step``.
# ---------------------------------------------------------------------------

def _per(values, n):
    return values if isinstance(values, list) else [values] * n


def _smul(tensors, values):
    """Each tensor times its value (one float, or one a tensor), rounded
    to the tensor's dtype first."""
    return torch._foreach_mul(tensors, _rounded(_per(values, len(tensors)),
                                                tensors))


def _sadd(tensors, values):
    """Each tensor plus its value, rounded to the tensor's dtype first."""
    return torch._foreach_add(tensors, _rounded(_per(values, len(tensors)),
                                                tensors))


def _sdiv(tensors, values):
    """Each tensor divided by its value, rounded to the tensor's dtype
    first."""
    return torch._foreach_div(tensors, _rounded(_per(values, len(tensors)),
                                                tensors))


def _moment(state, decay, g, square=False):
    """``decay * s + (1 - decay) * g`` (``* g`` again with ``square``),
    each product rounded."""
    new = _smul(g, 1 - decay)
    if square:
        torch._foreach_mul_(new, g)
    return torch._foreach_add(_smul(state, decay), new)


def _clip_(tensors, bound):
    torch._foreach_clamp_min_(tensors, _scalars(-bound, tensors))
    torch._foreach_clamp_max_(tensors, _scalars(bound, tensors))


@register
class Signum(Optimizer):
    """signSGD (no momentum: ``w = w - lr * sign(g)``) and Signum:
    ``m = momentum * m - (1 - momentum) * g``,
    ``w = (1 - lr * wd_lh) * w + lr * sign(m)``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g = self._preprocess(gs, ws, wds)
        if not slots:
            torch._foreach_sub_(ws, _smul(torch._foreach_sign(g), lrs))
            return
        (moms,) = slots
        mom = self.momentum
        torch._foreach_copy_(moms, torch._foreach_sub(_smul(moms, mom),
                                                      _smul(g, 1 - mom)))
        torch._foreach_copy_(ws, torch._foreach_add(
            _smul(ws, [1 - lr * self.wd_lh for lr in lrs]),
            _smul(torch._foreach_sign(moms), lrs)))


@register
class FTML(Optimizer):
    """Follow the Moving Leader; the state is ``(d, v, z)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        b1, b2 = self.beta1, self.beta2
        g = self._preprocess(gs, ws, wds)
        d, v, z = slots
        torch._foreach_copy_(v, _moment(v, b2, g, square=True))
        root = torch._foreach_sqrt(_sdiv(v, [1 - b2 ** t for t in counts]))
        d_new = _smul(_sadd(root, self.epsilon),
                      [(1 - b1 ** t) / lr for lr, t in zip(lrs, counts)])
        sigma = torch._foreach_sub(d_new, _smul(d, b1))
        z_new = torch._foreach_add(_smul(z, b1), _smul(g, 1 - b1))
        torch._foreach_sub_(z_new, torch._foreach_mul(sigma, ws))
        torch._foreach_copy_(d, d_new)
        torch._foreach_copy_(z, z_new)
        torch._foreach_copy_(ws, torch._foreach_div(torch._foreach_neg(z), d))


@register
class LBSGD(Optimizer):
    """Large-batch SGD: SGD (with momentum) at ``lr`` times a multiplier
    that warms up from 1 to ``batch_scale`` over ``warmup_epochs``
    (``linear``, ``power2`` or ``sqrt``), or LARS's trust ratio
    ``||w|| / sqrt(||g||^2 + wd ||w||^2)`` clipped to [0.01, 100]
    (``warmup_strategy='lars'``)."""

    _in_order = True

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum, self.lbmult = momentum, 1.0
        self.warmup_strategy, self.warmup_epochs = (warmup_strategy,
                                                    warmup_epochs)
        self.batch_scale, self.num_epochs = batch_scale, num_epochs
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    _WARMUP_RAMPS = {
        "linear": lambda f: f,
        "power2": lambda f: f * f,
        "sqrt": math.sqrt,
    }

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nwup <= 1:
            return 1.0 if nup < nwup else maxmult
        if nup >= nwup:
            return maxmult
        ramp = self._WARMUP_RAMPS.get(self.warmup_strategy)
        if ramp is None:
            return 1.0
        return 1.0 + (maxmult - 1) * ramp(float(nup) / nwup)

    @staticmethod
    def _get_lars(weight, g, wd):
        w2 = float((weight * weight).sum())
        g2 = float((g * g).sum())
        lars = math.sqrt(w2 / (g2 + wd * w2 + 1e-18)) \
            if (g2 + wd * w2) > 0 else 1.0
        return min(max(lars, 0.01), 100)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        if self.warmup_strategy == "lars":
            mults = [self._get_lars(w, g, wd)
                     for w, g, wd in zip(ws, gs, wds)]
        else:
            mults = [self._get_lbmult(self.num_update)] * len(ws)
        lrs = [lr * m for lr, m in zip(lrs, mults)]
        g = self._preprocess(gs, ws, wds)
        if not slots:
            _sgd_step(ws, g, lrs)
            return
        (moms,) = slots
        torch._foreach_mul_(moms, _scalars(self.momentum, ws))
        torch._foreach_sub_(moms, _smul(g, lrs))
        torch._foreach_add_(ws, moms)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the gradient plus
    ``lamda * g * g * (w - w_prev)``, then SGD (with momentum); the state
    is ``(momentum or None, w_prev)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g = self._preprocess(gs, ws, wds)
        prev = slots[-1]
        comp = torch._foreach_mul(_smul(g, self.lamda), g)
        torch._foreach_mul_(comp, torch._foreach_sub(ws, prev))
        step = _smul(torch._foreach_add(g, comp), lrs)
        torch._foreach_copy_(prev, ws)
        if len(slots) == 1:
            torch._foreach_sub_(ws, step)
            return
        moms = slots[0]
        torch._foreach_copy_(moms, torch._foreach_sub(
            _smul(moms, self.momentum), step))
        torch._foreach_add_(ws, moms)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics:
    ``w = w - lr / 2 * g + sqrt(lr) * N(0, 1)``, the noise drawn in the
    weight's dtype from the port's generator of its device."""

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        from .. import random as _random
        g = self._preprocess(gs, ws, wds)
        noise = _smul([torch.randn(w.shape, dtype=w.dtype, device=w.device,
                                   generator=_random.generator(w.device))
                       for w in ws], [math.sqrt(lr) for lr in lrs])
        new = torch._foreach_sub(ws, _smul(g, [lr / 2 for lr in lrs]))
        torch._foreach_copy_(ws, torch._foreach_add(new, noise))


def _adamw_jitted(ws, gs, means, variances, scales, wds, rule):
    """AdamW's update of one width class in the arithmetic of the JAX
    package's jitted step (``scales``: each weight's ``lr`` in its
    dtype).  fp32: XLA folds ``rescale_grad`` into the moments' constants
    (``g * (rescale * (1 - beta1))``) where nothing is clipped between,
    each moment is one fused multiply-add, and so are ``+ wd * w`` and
    ``w - eta * (...)``.  Half width: every operation rounds in the
    weight's dtype, one after another."""
    b1, b2, eps, eta = rule.beta1, rule.beta2, rule.epsilon, rule.eta
    full = ws[0].dtype == torch.float32
    gs = [g.to(w.dtype) if g.dtype != w.dtype else g for g, w in zip(gs, ws)]
    dtype = ws[0].dtype
    rescale = _in_dtype(rule.rescale_grad, dtype)
    gg = torch._foreach_mul(gs, rescale)
    if rule.clip_gradient is None and full:
        gm = torch._foreach_mul(gs, _f32(rescale * _f32(1 - b1)))
        gv = torch._foreach_mul(gs, _f32(rescale * _f32(1 - b2)))
    else:
        if rule.clip_gradient is not None:
            _clip_(gg, rule.clip_gradient)
        gm = _smul(gg, 1 - b1)
        gv = _smul(gg, 1 - b2)
    torch._foreach_mul_(gv, gg)
    if full:
        new_m = _muladd_all(means, b1, gm)
        new_v = _muladd_all(variances, b2, gv)
    else:
        new_m = torch._foreach_add(_smul(means, b1), gm)
        new_v = torch._foreach_add(_smul(variances, b2), gv)
    torch._foreach_copy_(means, new_m)
    torch._foreach_copy_(variances, new_v)
    step = torch._foreach_div(_scaled(means, scales),
                              _sadd(torch._foreach_sqrt(variances), eps))
    if full:
        step = [torch.add(s, w, alpha=_f32(wd))
                for s, w, wd in zip(step, ws, wds)]
        for w, s in zip(ws, step):
            w.add_(s, alpha=-_f32(eta))
        return
    torch._foreach_add_(step, _smul(ws, wds))
    torch._foreach_sub_(ws, _smul(step, eta))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay and no bias correction:
    ``m = beta1 * m + (1 - beta1) * g``,
    ``v = beta2 * v + (1 - beta2) * g^2``,
    ``w = w - eta * (lr * m / (sqrt(v) + epsilon) + wd * w)``; the state is
    (m, v).  The gradient is rescaled and clipped, never decayed.  Its
    ``make_step`` takes the learning rate (in the weight's dtype) as the
    one value that changes from step to step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    _has_step = True

    def _fused_scale(self, lr, t, dtype):
        return _in_dtype(lr, dtype)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        means, variances = slots
        if fused:
            if scales is None:
                scales = self._fused_scales(lrs, counts, ws)
            for k in _width_groups(ws):
                _adamw_jitted(_pick(ws, k), _pick(gs, k), _pick(means, k),
                              _pick(variances, k), _pick(scales, k),
                              _pick(wds, k), self)
            return
        g = self._preprocess(gs, ws, [0.0] * len(ws))
        torch._foreach_copy_(means, _moment(means, self.beta1, g))
        torch._foreach_copy_(variances, _moment(variances, self.beta2, g,
                                                square=True))
        step = torch._foreach_div(
            _smul(means, lrs),
            _sadd(torch._foreach_sqrt(variances), self.epsilon))
        torch._foreach_add_(step, _smul(ws, wds))
        torch._foreach_sub_(ws, _smul(step, self.eta))


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``h = h + g^2``, ``w = w - lr * g / (sqrt(h) + eps)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g = self._preprocess(gs, ws, wds)
        (hist,) = slots
        torch._foreach_add_(hist, torch._foreach_mul(g, g))
        den = _sadd(torch._foreach_sqrt(hist), self.float_stable_eps)
        torch._foreach_sub_(ws, torch._foreach_div(_smul(g, lrs), den))


@register
class RMSProp(Optimizer):
    """RMSProp: ``n = (1 - gamma1) * g^2 + gamma1 * n``,
    ``w = w - lr * g / sqrt(n + epsilon)``; centred (Graves):
    ``gbar = (1 - gamma1) * g + gamma1 * gbar``,
    ``delta = gamma2 * delta - lr * g / sqrt(n - gbar^2 + epsilon)``,
    ``w = w + delta``.  ``clip_weights`` clips the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        g1, eps = self.gamma1, self.epsilon
        g = self._preprocess(gs, ws, wds)
        n = slots[0]
        sq = torch._foreach_mul(_smul(g, 1 - g1), g)
        torch._foreach_copy_(n, torch._foreach_add(sq, _smul(n, g1)))
        step = _smul(g, lrs)
        if not self.centered:
            torch._foreach_sub_(ws, torch._foreach_div(
                step, torch._foreach_sqrt(_sadd(n, eps))))
        else:
            gbar, delta = slots[1], slots[2]
            torch._foreach_copy_(gbar, torch._foreach_add(
                _smul(g, 1 - g1), _smul(gbar, g1)))
            var = _sadd(torch._foreach_sub(n, torch._foreach_mul(gbar, gbar)),
                        eps)
            torch._foreach_copy_(delta, torch._foreach_sub(
                _smul(delta, self.gamma2),
                torch._foreach_div(step, torch._foreach_sqrt(var))))
            torch._foreach_add_(ws, delta)
        if self.clip_weights:
            _clip_(ws, self.clip_weights)


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate):
    ``acc_g = rho * acc_g + (1 - rho) * g^2``,
    ``delta = sqrt(acc_d + eps) / sqrt(acc_g + eps) * g``,
    ``acc_d = rho * acc_d + (1 - rho) * delta^2``, ``w = w - delta``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        rho, eps = self.rho, self.epsilon
        g = self._preprocess(gs, ws, wds)
        acc_g, acc_d = slots
        torch._foreach_copy_(acc_g, _moment(acc_g, rho, g, square=True))
        delta = torch._foreach_div(torch._foreach_sqrt(_sadd(acc_d, eps)),
                                   torch._foreach_sqrt(_sadd(acc_g, eps)))
        torch._foreach_mul_(delta, g)
        torch._foreach_copy_(acc_d, _moment(acc_d, rho, delta, square=True))
        torch._foreach_sub_(ws, delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal: ``n = n + g^2``, ``z = z + g - (sqrt(n') - sqrt(n))
    / lr * w``, ``w = -(z - sign(z) * lamda1) / ((beta + sqrt(n)) / lr +
    wd)`` where ``|z| > lamda1``, else 0; the gradient is not decayed."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        l1 = self.lamda1
        g = self._preprocess(gs, ws, [0.0] * len(ws))
        z, n = slots
        n_new = torch._foreach_add(n, torch._foreach_mul(g, g))
        sigma = _sdiv(torch._foreach_sub(torch._foreach_sqrt(n_new),
                                         torch._foreach_sqrt(n)), lrs)
        z_new = torch._foreach_add(z, g)
        torch._foreach_sub_(z_new, torch._foreach_mul(sigma, ws))
        den = _sadd(_sdiv(_sadd(torch._foreach_sqrt(n_new), self.beta), lrs),
                    wds)
        num = torch._foreach_neg(torch._foreach_sub(
            z_new, _smul(torch._foreach_sign(z_new), l1)))
        new_w = torch._foreach_div(num, den)
        for w, zz, nw in zip(ws, z_new, new_w):
            w.copy_(torch.where(zz.abs() > _in_dtype(l1, zz.dtype), nw,
                                torch.zeros_like(nw)))
        torch._foreach_copy_(z, z_new)
        torch._foreach_copy_(n, n_new)


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm: ``u = max(beta2 * u, |g|)``,
    ``w = w - lr / (1 - beta1^t) * m / (u + 1e-8)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        b1 = self.beta1
        g = self._preprocess(gs, ws, wds)
        means, u = slots
        torch._foreach_copy_(means, _moment(means, b1, g))
        torch._foreach_copy_(u, torch._foreach_maximum(
            _smul(u, self.beta2), torch._foreach_abs(g)))
        lr_ts = [lr / (1.0 - b1 ** t) for lr, t in zip(lrs, counts)]
        torch._foreach_sub_(ws, torch._foreach_div(_smul(means, lr_ts),
                                                   _sadd(u, 1e-8)))


@register
class Nadam(Optimizer):
    """Nesterov Adam with the momentum schedule
    ``mu_t = beta1 * (1 - 0.5 * 0.96^(t * schedule_decay))``, whose
    running product ``m_schedule`` advances at every weight's update (a
    state of the optimizer object)."""

    _in_order = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _step(self, ws, gs, slots, lrs, wds, counts, fused, scales=None):
        b1, b2 = self.beta1, self.beta2
        mu, mu_next, sched, sched_next = [], [], [], []
        for t in counts:
            mu.append(b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay)))
            mu_next.append(b1 * (1.0 - 0.5 * 0.96 ** (
                (t + 1) * self.schedule_decay)))
            self.m_schedule = self.m_schedule * mu[-1]
            sched.append(1.0 - self.m_schedule)
            sched_next.append(1.0 - self.m_schedule * mu_next[-1])
        g = self._preprocess(gs, ws, wds)
        means, variances = slots
        g_prime = _sdiv(g, sched)
        torch._foreach_copy_(means, _moment(means, b1, g))
        m_prime = _sdiv(means, sched_next)
        torch._foreach_copy_(variances, _moment(variances, b2, g, square=True))
        v_prime = _sdiv(variances, [1.0 - b2 ** t for t in counts])
        m_bar = torch._foreach_add(_smul(g_prime, [1.0 - m for m in mu]),
                                   _smul(m_prime, mu_next))
        torch._foreach_sub_(ws, torch._foreach_div(
            _smul(m_bar, lrs),
            _sadd(torch._foreach_sqrt(v_prime), self.epsilon)))


@register
class Test(Optimizer):
    """The reference's test rule: ``w = w + g * rescale_grad``, with a
    state that never changes and no update count."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _update_count(self, indices):
        pass

    def _run(self, indices, ws, gs, states, fused, scales=None):
        with torch.no_grad():
            torch._foreach_add_(ws, _smul(gs, self.rescale_grad))


# ---------------------------------------------------------------------------
# Updater and the state files
# ---------------------------------------------------------------------------

_PORT, _JAX = "mxnet_tpu_torch", "mxnet_tpu"
# JAX-package modules whose pickled classes have a counterpart here
_PORTED_MODULES = ("ndarray.ndarray", "optimizer.optimizer", "lr_scheduler")


class _Foreign:
    """Stands in, while a state file of the JAX package is read, for any
    of its objects that has no counterpart here (the Gluon parameters and
    trainer its optimizer refers to); nothing reads these stand-ins."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == _JAX:
            sub = module[len(_JAX) + 1:]
            if sub in _PORTED_MODULES:
                found = getattr(importlib.import_module(
                    "%s.%s" % (_PORT, sub)), name, None)
                if found is not None:
                    return found
            return _Foreign
        if top in ("jax", "jaxlib", "ml_dtypes"):
            return _Foreign
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """Writes this package's classes under the JAX package's module names
    (``mxnet_tpu_torch.x`` as ``mxnet_tpu.x``), so that the JAX package's
    plain ``pickle.loads`` reads the file into its own classes."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if module == _PORT or module.startswith(_PORT + "."):
            self.write(pickle.GLOBAL
                       + (_JAX + module[len(_PORT):]).encode() + b"\n"
                       + (name or obj.__qualname__).encode() + b"\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _on_host(state):
    if isinstance(state, NDArray):
        return state.as_in_context(cpu())
    if isinstance(state, (tuple, list)):
        return type(state)(_on_host(s) for s in state)
    return state


class Updater:
    """Applies an optimizer to (index, grad, weight) triples and owns the
    per-index states."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}
        self.states_synced: Dict[int, bool] = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        """Update one weight, or lists of them in one pass."""
        self._update(index, grad, weight, False)

    def _trainer_update(self, index, grad, weight, scales=None):
        """As a call, in the arithmetic of the JAX package's
        ``Trainer.step`` (see :meth:`Optimizer._update_multi_precision`,
        which takes ``scales``)."""
        self._update(index, grad, weight, True, scales)

    def _update(self, index, grad, weight, fused, scales=None):
        if isinstance(index, (list, tuple)):
            indices, grads, weights = list(index), list(grad), list(weight)
        else:
            indices, grads, weights = [index], [grad], [weight]
        states = self._states(indices, weights)
        if fused:
            self.optimizer._update_multi_precision(indices, weights, grads,
                                                   states, True, scales)
        else:
            self.optimizer.update_multi_precision(indices, weights, grads,
                                                  states)

    def _states(self, indices, weights):
        """The states of ``indices``, made at first use and moved to their
        weights' devices."""
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(
                    i, w)
                self.states_synced[i] = True
            elif not self.states_synced[i]:
                self.states[i] = self.sync_state_context(self.states[i],
                                                         w.context)
                self.states_synced[i] = True
        return [self.states[i] for i in indices]

    def sync_state_context(self, state, context):
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(s, context)
                               for s in state)
        return state

    def set_states(self, states):
        """Read what :meth:`get_states` of either package wrote; a
        2-tuple carries the optimizer too.  The arrays land on the host and
        move to their weight's device at its next update."""
        payload = _Unpickler(io.BytesIO(states)).load()
        with_optimizer = isinstance(payload, tuple) and len(payload) == 2
        self.states = payload[0] if with_optimizer else payload
        if with_optimizer:
            self.optimizer = payload[1]
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer) in the JAX package's format."""
        states = {i: _on_host(s) for i, s in self.states.items()}
        buf = io.BytesIO()
        _Pickler(buf, protocol=4).dump((states, self.optimizer)
                                       if dump_optimizer else states)
        return buf.getvalue()


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
