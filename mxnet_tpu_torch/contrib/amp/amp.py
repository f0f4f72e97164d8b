"""Automatic mixed precision, the port of ``mxnet_tpu/contrib/amp/amp.py``.

``init`` installs one cast policy that the ``mx.nd`` dispatch consults
before every op call (``ops/registry.py:set_cast_policy``): the ops of
``lists.TARGET_DTYPE_OPS`` (``FullyConnected``, the convolutions, the
batched products) take their floating inputs in the target dtype,
float16 or bfloat16, those of ``lists.FP32_OPS`` (``LayerNorm``,
``softmax``, the reductions) in float32, and the ops of
``lists.WIDEST_TYPE_CASTS`` in the widest of their input dtypes.  The
casts run inside the recorded op call, so gradients flow back to the
float32 weights in float32.  An op in no list, or called around the
dispatch, runs in the dtypes it is given: the transformer's attention
takes the float16 q, k and v of its float16 projection.

``init_trainer`` attaches a loss scaler to a ``gluon.Trainer``: for
float16 the dynamic one, whose overflow check gates the whole step; for
bfloat16 an inert one.  ``scale_loss`` scales the loss and sets the
trainer's ``_scale`` so that its step divides the gradients by the same
factor.  ``convert_symbol`` and ``convert_model`` rewrite a Symbol graph
with ``amp_cast`` nodes, as the JAX package's do.  The cast policy reaches
the ``mx.nd`` dispatch only: an ``Executor`` (and so ``Module``) runs its
ops in the dtypes it is given, also after ``init``, as the JAX package's
Executor does.
"""
from __future__ import annotations

import contextlib
import logging
import warnings

import torch

from ...base import torch_dtype
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_symbol", "convert_hybrid_block",
           "list_bf16_ops", "list_fp16_ops", "list_fp32_ops",
           "is_initialized", "disable"]


class _AmpState:
    def __init__(self):
        self.initialized = False
        self.target_dtype = "bfloat16"
        self.target_ops = set()
        self.fp32_ops = set()
        self.widest_ops = set()
        self.conditional = []


_STATE = _AmpState()
_FLOATS = ("float16", "bfloat16", "float32", "float64")


def _widest(dtypes):
    order = {"float16": 0, "bfloat16": 0, "float32": 1, "float64": 2}
    best = None
    for d in dtypes:
        s = str(d)
        if s in order and (best is None or order[s] > order[best]):
            best = s
    return best


class _Policy:
    """``policy(op_name, dtypes, attrs)`` -> the cast target or None."""

    def __init__(self, state):
        self._s = state

    def __call__(self, op_name, dtypes, attrs=None):
        s = self._s
        for cop, carg, cvals in s.conditional:
            if op_name == cop and attrs is not None \
                    and attrs.get(carg) in cvals:
                return "float32"
        if op_name in s.target_ops:
            return s.target_dtype
        if op_name in s.fp32_ops:
            return "float32"
        if op_name in s.widest_ops:
            if len({str(d) for d in dtypes if str(d) in _FLOATS}) > 1:
                return _widest(dtypes)
        return None


def _dtype_name(dtype):
    return str(torch_dtype(dtype)).replace("torch.", "")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for the process: ``target_dtype`` is ``"bfloat16"`` or
    ``"float16"``; the op lists default to ``lists``."""
    from ...ops import registry
    target_dtype = _dtype_name(target_dtype)
    assert target_dtype in ("bfloat16", "float16"), target_dtype
    if _STATE.initialized:
        warnings.warn("amp.init() called twice; reinitializing")
    _STATE.target_dtype = target_dtype
    _STATE.target_ops = set(target_precision_ops
                            if target_precision_ops is not None
                            else lists.TARGET_DTYPE_OPS)
    _STATE.fp32_ops = set(fp32_ops if fp32_ops is not None
                          else lists.FP32_OPS)
    _STATE.widest_ops = set(lists.WIDEST_TYPE_CASTS)
    _STATE.conditional = list(conditional_fp32_ops
                              if conditional_fp32_ops is not None
                              else lists.CONDITIONAL_FP32_OPS)
    registry.set_cast_policy(_Policy(_STATE))
    _STATE.initialized = True
    logging.info("AMP initialized (target dtype %s)", target_dtype)


def is_initialized():
    return _STATE.initialized


def disable():
    """Uninstall the cast policy."""
    from ...ops import registry
    registry.set_cast_policy(None)
    _STATE.initialized = False


def init_trainer(trainer):
    """Attach loss scaling to a ``gluon.Trainer``: for float16 the dynamic
    scaler, whose overflow check (one ``multi_all_finite`` over every
    gradient) skips the step and lowers the scale; for bfloat16 an inert
    scaler at 1."""
    assert _STATE.initialized, "call amp.init() before init_trainer()"
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        return
    if _STATE.target_dtype != "float16":
        trainer._amp_loss_scaler = LossScaler(init_scale=1.0,
                                              scale_factor=1.0,
                                              scale_window=1 << 62)
        trainer._amp_original_scale = trainer._scale
        return
    scaler = LossScaler()
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_scale = trainer._scale
    orig_step = trainer.step

    def _amp_step(batch_size, ignore_stale_grad=False):
        grads = [p.grad() for p in trainer._params
                 if p.grad_req != "null"]
        overflow = scaler.has_overflow(grads)
        if not overflow:
            orig_step(batch_size, ignore_stale_grad)
        scaler.update_scale(overflow)

    trainer.step = _amp_step


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """The loss times the trainer's loss scale, with the trainer's
    ``_scale`` set so that its step divides the gradients by it.  Enter it
    inside ``autograd.record()`` and call ``backward`` on what it
    yields."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    if scaler.loss_scale == 1.0:
        trainer._scale = trainer._amp_original_scale
        yield loss
        return
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the current gradients by the loss scale (for clipping between
    ``backward`` and ``step``); the step then divides by nothing more."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req != "null":
                g = p.grad()._data
                g.copy_(g / scaler.loss_scale)
    trainer._scale = trainer._amp_original_scale


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, data_names=None,
                   cast_optional_params=False):
    """A copy of the graph ``sym`` with an ``amp_cast`` node on every input
    of each op of ``target_dtype_ops`` (to ``target_dtype``) and of
    ``fp32_ops`` (to float32), the nodes named in ``excluded_sym_names``
    left alone: the JAX package's graph, node for node and name for
    name."""
    from ...symbol.symbol import Symbol, _SymNode
    target_dtype = _dtype_name(target_dtype)
    target_ops = set(target_dtype_ops if target_dtype_ops is not None
                     else lists.TARGET_DTYPE_OPS)
    f32_ops = set(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    excluded = set(excluded_sym_names or [])
    mapping = {}

    def cast_entry(entry, dtype, hint, slot):
        node = _SymNode("amp_cast",
                        "%s_%s_amp_cast_%s" % (hint, slot, dtype),
                        {"dtype": dtype}, [entry], in_names=["data"])
        return (node, 0)

    for node in Symbol(sym._entries)._topo():
        if node.op is None:
            mapping[id(node)] = node
            continue
        inputs = [(mapping[id(c)], i) for c, i in node.inputs]
        if node.name not in excluded:
            slots = node.in_names or [str(i) for i in range(len(inputs))]
            if node.op in target_ops:
                inputs = [cast_entry(e, target_dtype, node.name, s)
                          for e, s in zip(inputs, slots)]
            elif node.op in f32_ops:
                inputs = [cast_entry(e, "float32", node.name, s)
                          for e, s in zip(inputs, slots)]
        mapping[id(node)] = _SymNode(node.op, node.name, dict(node.attrs),
                                     inputs, in_names=node.in_names)
    return Symbol([(mapping[id(n)], i) for n, i in sym._entries])


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """``(convert_symbol(sym, ...), arg_params, aux_params)``: the
    parameters stay in their dtypes unless ``cast_optional_params``."""
    new_sym = convert_symbol(sym, target_dtype, target_dtype_ops, fp32_ops,
                             conditional_fp32_ops, excluded_sym_names,
                             cast_optional_params=cast_optional_params)
    if cast_optional_params:
        arg_params = {k: v.astype(_dtype_name(target_dtype))
                      for k, v in arg_params.items()}
    return new_sym, dict(arg_params), dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         ctx=None, cast_optional_params=False):
    """Turn AMP on if it is off, cast the block's parameters with
    ``cast_optional_params``, and hybridize the block again: its CUDA
    graphs, captured without the casts, are dropped, and the next call
    captures the mixed-precision forward."""
    if not _STATE.initialized:
        init(target_dtype=target_dtype,
             target_precision_ops=target_dtype_ops, fp32_ops=fp32_ops,
             conditional_fp32_ops=conditional_fp32_ops)
    if cast_optional_params:
        block.cast(target_dtype)
    if hasattr(block, "hybridize"):
        block.hybridize()
    return block


def list_bf16_ops():
    return list(lists.TARGET_DTYPE_OPS)


def list_fp16_ops():
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops():
    return list(lists.FP32_OPS)
