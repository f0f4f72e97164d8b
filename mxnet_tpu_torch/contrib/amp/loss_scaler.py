"""Dynamic loss scaling, the port's ``mxnet_tpu/contrib/amp/loss_scaler.py``.

Needed for float16 only: bfloat16 has float32's exponent range, so AMP
installs an inert scaler for it.  The dynamics are the JAX package's:
scale up by ``scale_factor`` after every ``scale_window`` clean steps,
divide by it (down to 1) on an overflow, whose step is skipped.
"""
from __future__ import annotations

import logging

from ...ops.contrib_ops import multi_all_finite

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        # tolerance is accepted for the reference's signature; the
        # dynamics do not read it
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._has_overflow = False

    def has_overflow(self, params):
        """True if any of the arrays (gradients, NDArrays or tensors) holds
        a value that is not finite: one ``multi_all_finite`` over them all
        and one read back to the host."""
        if not params:
            self._has_overflow = False
            return False
        vals = [p._data if hasattr(p, "_data") else p for p in params]
        self._has_overflow = not bool(multi_all_finite(*vals).item())
        return self._has_overflow

    def update_scale(self, overflow):
        """The scale after a step that did (``overflow``) or did not
        overflow."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
            logging.info("AMP: overflow detected, lowering loss scale to "
                         "%g", self.loss_scale)
        else:
            self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
