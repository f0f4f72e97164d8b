"""Gluon losses: every loss of ``mxnet_tpu/gluon/loss.py``.

Counterpart of the same classes in the JAX package, in the same formulas
and order of operations: the log-softmax subtracts the (gradient-stopped)
row maximum, and every loss but the triplet, CTC, cosine and Poisson ones
averages over all axes but the batch axis.  Each is a HybridBlock whose
math runs on the operands' tensors in :func:`autograd.op_scope`, so it is
recorded only inside ``autograd.record()``; ``maximum`` splits its
gradient at a tie, as the JAX package's does.  ``CTCLoss`` runs the JAX
package's log-space forward recursion over time, one step after another
(blank is class 0, ``-1e30`` stands for minus infinity, so an impossible
alignment costs about ``1e30``, not ``inf``).
"""
from __future__ import annotations

import math

import torch

from .. import autograd
from ..base import numeric_types
from ..ndarray.ndarray import _wrap
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


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


def _max0(x):
    """``maximum(x, 0)``, its gradient split at a tie as the JAX
    package's ``jnp.maximum``."""
    return torch.maximum(x, x.new_zeros(()))


def _softplus_part(p):
    """``log(1 + exp(-|p|))``."""
    return torch.log1p(torch.exp(-torch.abs(p)))


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

    def forward(self, x, *args, **kwargs):
        from .. import ndarray as nd
        return self.hybrid_forward(nd, x, *args, **kwargs)

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


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy from logits (``max(p, 0) - p * l +
    log(1 + exp(-|p|))``, weighted by ``pos_weight``), or from
    probabilities with ``from_sigmoid`` (``eps`` 1e-12 in the logs)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        with autograd.op_scope():
            p = pred._data
            l = label._data.reshape(p.shape)
            pw = _tensor(pos_weight)
            if not self._from_sigmoid:
                if pw is None:
                    loss = _max0(p) - p * l + _softplus_part(p)
                else:
                    log_weight = 1 + (pw - 1) * l
                    loss = p - p * l + log_weight * (
                        _softplus_part(p) + _max0(-p))
            else:
                eps = 1e-12
                if pw is None:
                    loss = -(torch.log(p + eps) * l
                             + torch.log(1. - p + eps) * (1. - l))
                else:
                    loss = -(torch.log(p + eps) * l * pw
                             + torch.log(1. - p + eps) * (1. - l))
            loss = _apply_weighting(loss, self._weight,
                                    _tensor(sample_weight))
            return _wrap(_mean_keep_batch(loss, self._batch_axis))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - log_pred)``, the prediction taken
    as log-probabilities (``from_logits``) or log-softmaxed first."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def _loss(self, p, l, sw):
        logp = p if self._from_logits else _log_softmax(p, self._axis)
        loss = l * (torch.log(l + 1e-12) - logp)
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


_NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` with the JAX package's derivative,
    ``exp(a - out)`` and ``exp(b - out)``: where both sides stand at
    ``-1e30`` the sum rounds back to ``-1e30`` and each side takes the
    whole gradient, which is what an impossible CTC alignment's gradient
    is made of there."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, out = ctx.saved_tensors
        return grad * torch.exp(a - out), grad * torch.exp(b - out)


def _ctc_nll(log_probs, labels, plen, llen):
    """``-log p(label | input)`` of each sequence: the forward recursion
    over the extended label (blanks between and around the labels) in log
    space, ``log_probs`` (T, N, C), ``labels`` (N, L) int64 with padding
    already 0, ``plen``/``llen`` (N,) int64.  A step at or past a
    sequence's ``plen`` keeps its alpha."""
    T, N, _ = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    ext = labels.new_zeros((N, S))
    ext[:, 1::2] = labels
    lp0 = log_probs[0]
    alpha = torch.cat([lp0[:, :1],
                       torch.gather(lp0, 1, ext[:, 1:2]),
                       lp0.new_full((N, S - 2), _NEG_INF)], dim=1)
    skip = torch.cat([torch.ones((N, 2), dtype=torch.bool,
                                 device=ext.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = lp0.new_full((N, 1), _NEG_INF)
    pad2 = lp0.new_full((N, 2), _NEG_INF)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        shift2 = torch.where(skip, pad1, shift2)
        merged = _LogAddExp.apply(_LogAddExp.apply(alpha, shift1), shift2)
        new = merged + torch.gather(log_probs[t], 1, ext)
        alpha = torch.where((t < plen)[:, None], new, alpha)
    end1 = 2 * llen
    end2 = torch.clamp_min(2 * llen - 1, 0)
    a1 = torch.gather(alpha, 1, end1[:, None])[:, 0]
    a2 = torch.gather(alpha, 1, end2[:, None])[:, 0]
    return -_LogAddExp.apply(a1, a2)


class CTCLoss(Loss):
    """Connectionist temporal classification, blank = class 0.

    ``pred`` is (N, T, C) (``layout='NTC'``) or (T, N, C); ``label`` (N, L)
    or (L, N).  A label sequence ends at its first 0 or -1 unless
    ``label_lengths`` gives its length; ``pred_lengths`` cuts each input
    short.  The loss of each sequence is not averaged."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise AssertionError("Only 'NTC' and 'TNC' layouts are "
                                 "supported")
        if label_layout not in ("NT", "TN"):
            raise AssertionError("Only 'NT' and 'TN' label layouts are "
                                 "supported")
        self._layout = layout
        self._label_layout = label_layout
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        with autograd.op_scope():
            p, lab = pred._data, label._data
            if self._layout == "NTC":
                p = p.permute(1, 0, 2)
            if self._label_layout == "TN":
                lab = lab.t()
            T, N, _ = p.shape
            labels = lab.to(torch.int64)
            plen = torch.full((N,), T, dtype=torch.int64, device=p.device) \
                if pred_lengths is None else pred_lengths._data.to(
                    torch.int64)
            if label_lengths is None:
                llen = (labels > 0).to(torch.int64).sum(dim=1)
            else:
                llen = label_lengths._data.to(torch.int64)
            nll = _ctc_nll(_log_softmax(p, -1), torch.clamp_min(labels, 0),
                           plen, llen)
            return _wrap(_apply_weighting(nll, self._weight,
                                          _tensor(sample_weight)))


class HuberLoss(Loss):
    """Smooth L1: ``|e| - rho / 2`` above ``rho``, ``e^2 / (2 rho)``
    below."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _loss(self, p, l, sw):
        loss = torch.abs(l.reshape(p.shape) - p)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, p, l, sw):
        loss = _max0(self._margin - p * l.reshape(p.shape))
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, p, l, sw):
        loss = torch.square(_max0(self._margin - p * l.reshape(p.shape)))
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for labels in {-1, 1}
    (``label_format='signed'``) or {0, 1} (``'binary'``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "received %s." % label_format)

    def _loss(self, p, l, sw):
        l = l.reshape(p.shape)
        if self._label_format == "signed":
            l = (l + 1.0) / 2.0
        loss = _max0(p) - p * l + _softplus_part(p)
        loss = _apply_weighting(loss, self._weight, sw)
        return _mean_keep_batch(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |a - pos|^2 - |a - neg|^2 + margin)``, summed over each
    sample's features."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        with autograd.op_scope():
            a = pred._data
            pos = positive._data.reshape(a.shape)
            neg = negative._data.reshape(a.shape)
            axes = tuple(range(1, a.dim()))
            loss = torch.sum(torch.square(a - pos) - torch.square(a - neg),
                             dim=axes)
            loss = _max0(loss + self._margin)
            return _wrap(_apply_weighting(loss, self._weight, None))


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, ``exp(pred) - target * pred``
    (``from_logits``) or ``pred - target * log(pred + epsilon)``, plus
    Stirling's term where the target exceeds 1 (``compute_full``),
    averaged over everything (a scalar)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        with autograd.op_scope():
            p = pred._data
            t = target._data.reshape(p.shape)
            if self._from_logits:
                loss = torch.exp(p) - t * p
            else:
                loss = p - t * torch.log(p + epsilon)
            if self._compute_full:
                stirling = t * torch.log(t) - t + 0.5 * torch.log(
                    2 * t * math.pi)
                stirling = torch.where(t > 1, stirling,
                                       torch.zeros_like(stirling))
                loss = loss + stirling
            loss = _apply_weighting(loss, self._weight,
                                    _tensor(sample_weight))
            return _wrap(torch.mean(loss))


class CosineEmbeddingLoss(Loss):
    """``1 - cos(x1, x2)`` for label 1, ``max(0, cos(x1, x2) - margin)``
    otherwise, each sample's features flattened."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        with autograd.op_scope():
            x1 = input1._data.reshape(input1.shape[0], -1)
            x2 = input2._data.reshape(input2.shape[0], -1)
            l = label._data.reshape(-1)
            norms = torch.linalg.vector_norm(x1, dim=1) * \
                torch.linalg.vector_norm(x2, dim=1)
            cos = torch.sum(x1 * x2, dim=1) / torch.maximum(
                norms, norms.new_tensor(1e-12))
            loss = torch.where(l == 1, 1.0 - cos,
                               _max0(cos - self._margin))
            return _wrap(_apply_weighting(loss, self._weight,
                                          _tensor(sample_weight)))
