"""Declarative operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` with the same
``OpDef``/``register``/``get_op`` surface.  An op here is a plain
function on ``torch.Tensor``s, ``fn(*tensors, **attrs)``; registered ops
appear as ``mx.nd.<name>`` and as ``NDArray`` methods.  The AMP
cast-policy hook (:func:`set_cast_policy`) is consulted by the ``mx.nd``
dispatch before each op call, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

__all__ = ["OpDef", "register", "get_op", "list_ops", "alias",
           "set_cast_policy", "get_cast_policy"]


class OpDef:
    """A registered operator."""

    __slots__ = ("name", "fn", "num_outputs", "differentiable", "needs_rng",
                 "needs_training", "doc")

    def __init__(self, name: str, fn: Callable, num_outputs: int = 1,
                 differentiable: bool = True, needs_rng: bool = False,
                 needs_training: bool = False, doc: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.needs_rng = needs_rng
        self.needs_training = needs_training
        self.doc = doc or (fn.__doc__ if fn is not None else None)

    def __repr__(self):
        return "OpDef(%s)" % self.name


_OPS: Dict[str, OpDef] = {}


def register(name: str, *, num_outputs: int = 1, differentiable: bool = True,
             needs_rng: bool = False, needs_training: bool = False,
             aliases: Sequence[str] = ()):
    """Decorator registering ``fn(*tensors, **attrs)`` as an operator."""

    def _reg(fn: Callable) -> Callable:
        op = OpDef(name, fn, num_outputs=num_outputs,
                   differentiable=differentiable, needs_rng=needs_rng,
                   needs_training=needs_training)
        _OPS[name] = op
        for a in aliases:
            _OPS[a] = op
        return fn

    return _reg


def alias(existing: str, *names: str) -> None:
    """Register ``names`` as further names of the op ``existing``."""
    op = _OPS[existing]
    for n in names:
        _OPS[n] = op


def get_op(name: str) -> Optional[OpDef]:
    return _OPS.get(name)


# The AMP cast-policy hook: installed by ``contrib.amp.init()`` and read by
# the ``mx.nd`` dispatch (``ndarray/__init__.py``) before each op call.
_CAST_POLICY = None


def set_cast_policy(policy) -> None:
    """``policy(op_name, input_dtypes, static_attrs)`` -> the dtype name to
    cast the op's floating NDArray inputs to, or None; ``input_dtypes`` are
    the names of the NDArray inputs' dtypes (``"float16"``...) and
    ``static_attrs`` the op's other keyword arguments.  None uninstalls."""
    global _CAST_POLICY
    _CAST_POLICY = policy


def get_cast_policy():
    return _CAST_POLICY


def list_ops():
    return sorted(_OPS.keys())
