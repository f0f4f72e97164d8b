"""One Symbol node's evaluation on torch tensors.

Counterpart of ``mxnet_tpu/symbol/_eval.py``: the Executor's walk and shape
inference both call :func:`eval_node`, so the vararg pseudo-ops (Concat,
add_n, stack: any number of inputs, no signature in the registry) have one
dispatch site, and every other node runs through its registered op's
function, never another path.  A sampler (``needs_rng``) is handed
``gen``; ``Dropout`` and ``RNN`` draw from the port's generator of their
data's device themselves.  The AMP cast policy is not consulted here, as
the JAX package's ``eval_node`` does not consult it.
"""
from __future__ import annotations

import torch

from ..ops.registry import get_op


def eval_node(node, ins, gen, training):
    """Apply ``node``'s op to the tensors ``ins``: a tuple of outputs."""
    attrs = dict(node.attrs)
    attrs.pop("num_args", None)
    if node.op in ("Concat", "concat"):
        return (torch.cat(ins, dim=int(attrs.get("dim", 1))),)
    if node.op in ("add_n", "ElementWiseSum", "elemwise_sum"):
        return (sum(ins[1:], ins[0]),)
    if node.op == "stack":
        return (torch.stack(ins, dim=int(attrs.get("axis", 0))),)
    op = get_op(node.op)
    if op.needs_training:
        attrs["training"] = training
    if op.needs_rng:
        res = op.fn(gen, *ins, **attrs)
    else:
        res = op.fn(*ins, **attrs)
    return tuple(res) if isinstance(res, (tuple, list)) else (res,)
