"""Optimizers and the updater that owns their states.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` for ``SGD`` (with
momentum), ``NAG`` and ``Adam``: the ``Optimizer`` base with its name
registry, learning-rate and weight-decay multipliers, update counting,
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
           "SGD", "NAG", "Adam", "pin_update_dtypes", "DeviceScales"]


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

    # -- updates --------------------------------------------------------
    def update(self, index, weight, grad, state):
        """Update one weight (or, given lists, several) with its state, as
        the JAX package's ``Updater`` does: one eager operation after
        another."""
        indices, weights, grads, states = _as_lists(index, weight, grad,
                                                    state)
        self._update_count(indices)
        self._run(indices, [w._data for w in weights],
                  [g._data for g in grads], states, False)

    def update_multi_precision(self, index, weight, grad, state):
        """As :meth:`update`; a half-width weight under ``multi_precision``
        is updated through its fp32 master (state leaf 0) and then set to
        the master's value."""
        self._update_multi_precision(index, weight, grad, state, False)

    def _update_multi_precision(self, index, weight, grad, state, fused):
        """:meth:`update_multi_precision`; ``fused``: as the JAX package's
        ``Trainer.step`` updates, through the optimizer's jitted step (see
        :meth:`_step`)."""
        indices, weights, grads, states = _as_lists(index, weight, grad,
                                                    state)
        self._update_count(indices)
        half = [self.multi_precision and self._is_half(w._data.dtype)
                for w in weights]
        full = [k for k, h in enumerate(half) if not h]
        if full:
            self._run([indices[k] for k in full],
                      [weights[k]._data for k in full],
                      [grads[k]._data for k in full],
                      [states[k] for k in full], fused)
        mp = [k for k, h in enumerate(half) if h]
        if mp:
            masters = [states[k][0]._data for k in mp]
            # the jitted step widens the gradient itself
            self._run([indices[k] for k in mp], masters,
                      [grads[k]._data if fused else grads[k]._data.float()
                       for k in mp], [states[k][1] for k in mp], fused)
            with torch.no_grad():
                for k, m in zip(mp, masters):
                    weights[k]._data.copy_(m)

    def _run(self, indices, ws, gs, states, fused):
        leaves = [_leaves(s) for s in states]
        slots = [list(col) for col in zip(*leaves)] if leaves and leaves[0] \
            else []
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

    def _trainer_update(self, index, grad, weight):
        """As a call, in the arithmetic of the JAX package's
        ``Trainer.step`` (see :meth:`Optimizer._update_multi_precision`)."""
        self._update(index, grad, weight, True)

    def _update(self, index, grad, weight, fused):
        if isinstance(index, (list, tuple)):
            indices, grads, weights = list(index), list(grad), list(weight)
        else:
            indices, grads, weights = [index], [grad], [weight]
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(
                    i, w)
                self.states_synced[i] = True
            elif not self.states_synced[i]:
                self.states[i] = self.sync_state_context(self.states[i],
                                                         w.context)
                self.states_synced[i] = True
        states = [self.states[i] for i in indices]
        if fused:
            self.optimizer._update_multi_precision(indices, weights, grads,
                                                   states, True)
        else:
            self.optimizer.update_multi_precision(indices, weights, grads,
                                                  states)

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
