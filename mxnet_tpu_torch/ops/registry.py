"""Declarative operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` with the same
``OpDef``/``register``/``get_op`` surface.  An op here is a plain
function on ``torch.Tensor``s, ``fn(*tensors, **attrs)``; registered ops
appear as ``mx.nd.<name>`` and as ``NDArray`` methods.  The AMP
cast-policy hook waits for the mixed-precision port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

__all__ = ["OpDef", "register", "get_op", "list_ops"]


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


def get_op(name: str) -> Optional[OpDef]:
    return _OPS.get(name)


def list_ops():
    return sorted(_OPS.keys())
