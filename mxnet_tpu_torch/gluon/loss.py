"""Gluon losses: ``Loss``, ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss``.

Counterpart of the same classes in ``mxnet_tpu/gluon/loss.py``, in the
same formulas and order of operations: the log-softmax subtracts the
(gradient-stopped) row maximum, and every loss averages over all axes but
the batch axis.  Each is a HybridBlock whose math runs on the operands'
tensors in :func:`autograd.op_scope`, so it is recorded only inside
``autograd.record()``.  The other losses come with later slices.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import numeric_types
from ..ndarray.ndarray import _wrap
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(loss, weight, sample_weight):
    """Per-sample weight, then the global scale."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, numeric_types):
            raise TypeError("weight must be a number")
        loss = loss * weight
    return loss


def _mean_keep_batch(loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


def _log_softmax(x, axis=-1):
    shifted = x - torch.amax(x, dim=axis, keepdim=True).detach()
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=axis,
                                         keepdim=True))


def _tensor(a):
    return None if a is None else a._data


class Loss(HybridBlock):
    """Base loss: a global ``weight`` and the ``batch_axis`` kept by the
    mean."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (self.__class__.__name__,
                                            self._batch_axis, self._weight)

    def _loss(self, pred, label, sample_weight):
        """The per-sample loss from tensors."""
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        with autograd.op_scope():
            return _wrap(self._loss(pred._data, label._data,
                                    _tensor(sample_weight)))


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` averaged per sample."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, p, l, sw):
        loss = torch.square(l.reshape(p.shape) - p)
        loss = _apply_weighting(loss, self._weight / 2 if self._weight
                                else None, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class L1Loss(Loss):
    """``weight * |pred - label|`` averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, p, l, sw):
        loss = torch.abs(l.reshape(p.shape) - p)
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross entropy in one: ``-log_softmax(pred)[label]``
    for class-index labels (``sparse_label``), else
    ``-sum(log_softmax(pred) * label)``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _loss(self, p, l, sw):
        logp = p if self._from_logits else _log_softmax(p, self._axis)
        if self._sparse_label:
            lab = l.to(torch.int64).unsqueeze(self._axis)
            loss = -torch.gather(logp, self._axis, lab).squeeze(self._axis)
        else:
            loss = -torch.sum(logp * l.reshape(logp.shape), dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
