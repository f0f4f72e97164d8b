"""Learning-rate schedules as pure functions of the update count.

Counterpart of ``mxnet_tpu/lr_scheduler.py``, a copy of its five
schedulers (the port imports nothing of the JAX package): ``LRScheduler``
(the base, with a linear or constant warmup), ``FactorScheduler``,
``MultiFactorScheduler``, ``PolyScheduler`` and ``CosineScheduler``.
Each is a closed-form map ``num_update -> lr``; ``base_lr`` stays a plain
attribute, which the Optimizer sets to its learning rate.  The attribute
names are the JAX package's, so a pickled scheduler reads in either.
"""
from __future__ import annotations

import bisect
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: holds ``base_lr`` and the warmup ramp (reference
    lr_scheduler.py:22).  Subclasses implement ``_decayed_lr`` for the
    post-warmup region."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if not isinstance(warmup_steps, int) or warmup_steps < 0:
            raise ValueError("warmup_steps must be a non-negative int, got %r"
                             % (warmup_steps,))
        if warmup_begin_lr > base_lr:
            raise ValueError(
                "warmup must ramp up: warmup_begin_lr %g exceeds base_lr %g"
                % (warmup_begin_lr, base_lr))
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant', "
                             "got %r" % (warmup_mode,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    @property
    def warmup_final_lr(self):
        return self.base_lr

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        ramp = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr + ramp * (self.base_lr
                                              - self.warmup_begin_lr)

    def _decayed_lr(self, num_update):
        raise NotImplementedError()

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed_lr(num_update)


class FactorScheduler(LRScheduler):
    """Geometric decay: one ``factor`` multiply per ``step`` updates,
    floored at ``stop_factor_lr`` (reference lr_scheduler.py:78).

    Closed form: after ``n`` updates the lr has decayed
    ``floor((n-1)/step)`` times.
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("decay interval must cover at least 1 update, "
                             "got step=%r" % (step,))
        if factor > 1.0:
            raise ValueError("a decay factor above 1 would grow the lr, "
                             "got %r" % (factor,))
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decayed_lr(self, num_update):
        n_decays = max(0, num_update - 1) // self.step
        return max(self.stop_factor_lr, self.base_lr
                   * self.factor ** n_decays)


class MultiFactorScheduler(LRScheduler):
    """One ``factor`` multiply as each milestone in ``step`` is passed
    (reference lr_scheduler.py:127).  Closed form: the decay count is the
    number of milestones strictly below ``num_update`` (bisect)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("milestones must cover at least 1 update")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must be strictly increasing")
        if factor > 1.0:
            raise ValueError("a decay factor above 1 would grow the lr, "
                             "got %r" % (factor,))
        self.step = step
        self.factor = factor

    def _decayed_lr(self, num_update):
        n_decays = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** n_decays


class _HorizonScheduler(LRScheduler):
    """Shared shape for Poly/Cosine: interpolate base_lr → final_lr over
    the (warmup-excluded) horizon, then hold final."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int, got %r"
                             % (max_update,))
        self.max_update = max_update
        self.final_lr = final_lr

    @property
    def max_steps(self):
        return self.max_update - self.warmup_steps

    def _progress(self, num_update):
        return (num_update - self.warmup_steps) / float(self.max_steps)

    def _decayed_lr(self, num_update):
        if num_update > self.max_update:
            num_update = self.max_update
        span = self.base_lr - self.final_lr
        return self.final_lr + span * self._shape(self._progress(num_update))

    def _shape(self, t):
        """Decay envelope on t ∈ [0, 1], from 1 down to 0."""
        raise NotImplementedError()


class PolyScheduler(_HorizonScheduler):
    """(1 - t)^pwr decay to final_lr (reference lr_scheduler.py:170)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _shape(self, t):
        return (1.0 - t) ** self.power


class CosineScheduler(_HorizonScheduler):
    """Half-cosine decay to final_lr (reference lr_scheduler.py:205)."""

    def _shape(self, t):
        return (1.0 + math.cos(math.pi * t)) / 2.0
