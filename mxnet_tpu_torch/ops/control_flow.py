"""Control-flow operators: ``foreach``, ``while_loop`` and ``cond``.

Counterpart of ``mxnet_tpu/ops/control_flow.py``; ``mx.nd.contrib``
re-exports them.  The JAX package lowers each to one ``lax.scan`` or
``lax.cond`` outside ``autograd.record()`` and runs it step by step under
it.  Here every call is a Python loop (or branch) over the package's ops,
which autograd records like any other op inside ``record()``, so
gradients reach the loop's inputs and the arrays its callables close over.

The results follow the JAX package's eager calls: ``foreach`` stacks each
step's outputs on a new axis 0; ``while_loop`` stacks the outputs of the
steps it ran, and, outside ``record()``, a loop that ran no step returns
one row of zeros shaped like one step's output (the JAX package's
``lax.scan`` over ``max_iterations`` steps trimmed to ``max(steps, 1)``
rows), inside it ``None``; ``cond`` runs the branch its predicate picks.
The callables take and return NDArrays or nested lists/tuples of them.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(x):
    """The NDArray leaves of a nested list/tuple of NDArrays, and the
    tree that :func:`_rebuild` fills with new leaves."""
    from ..ndarray import NDArray
    leaves = []

    def conv(a):
        if isinstance(a, NDArray):
            leaves.append(a)
            return ("leaf", len(leaves) - 1)
        if isinstance(a, (list, tuple)):
            return ("seq", [conv(i) for i in a], isinstance(a, tuple))
        raise TypeError("control-flow inputs must be NDArrays or nested "
                        "lists/tuples of NDArrays, got %s" % type(a))

    return leaves, conv(x)


def _rebuild(tree, vals):
    if tree[0] == "leaf":
        return vals[tree[1]]
    items = [_rebuild(t, vals) for t in tree[1]]
    return tuple(items) if tree[2] else items


def _stack_steps(rows):
    """Each leaf of the per-step results stacked on a new axis 0, in the
    first step's structure."""
    from ..ndarray import stack
    first, tree = _flatten(rows[0])
    cols = [[_flatten(r)[0][i] for r in rows] for i in range(len(first))]
    return _rebuild(tree, [stack(*c, axis=0) for c in cols])


def foreach(body, data, init_states):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data``; returns (the stacked outputs, the final states), each in
    ``body``'s structure."""
    leaves, tree = _flatten(data)
    states = init_states
    rows = []
    for t in range(leaves[0].shape[0]):
        out, states = body(_rebuild(tree, [l[t] for l in leaves]), states)
        rows.append(out)
    return _stack_steps(rows), states


def _truth(pred):
    """A predicate's value on the host: any nonzero entry is true."""
    from ..ndarray import NDArray
    if isinstance(pred, NDArray):
        return bool(torch.any(pred.astorch() != 0))
    return bool(onp.any(pred))


def while_loop(cond, func, loop_vars, max_iterations=None):
    """While ``cond(*loop_vars)`` holds, at most ``max_iterations`` times:
    ``func(*loop_vars) -> (step_output, new_loop_vars)``.  Returns (the
    stacked step outputs, the final loop vars in ``loop_vars``'
    structure)."""
    from .. import autograd
    from ..ndarray import zeros
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    _flatten(loop_vars)                 # NDArrays, or lists of them
    v_list = list(loop_vars) if isinstance(loop_vars, (list, tuple)) \
        else [loop_vars]
    rows = []
    for _ in range(max_iterations):
        if not _truth(cond(*v_list)):
            break
        out, new_vars = func(*v_list)
        rows.append(out)
        v_list = list(new_vars) if isinstance(new_vars, (list, tuple)) \
            else [new_vars]
    finals = v_list if len(v_list) > 1 else v_list[0]
    if rows:
        return _stack_steps(rows), finals
    if autograd.is_recording():
        return None, finals
    # no step ran: one zero row shaped like a step's output, which needs
    # the output's structure, so run the step once for it and drop it
    with autograd.pause():
        probe, _ = func(*v_list)
    out_leaves, out_tree = _flatten(probe)
    return _rebuild(out_tree, [
        zeros((1,) + l.shape, ctx=l.context, dtype=l.dtype)
        for l in out_leaves]), finals


def cond(pred, then_func, else_func):
    """``then_func()`` when ``pred`` (an NDArray or a Python value) is
    true, else ``else_func()``."""
    return then_func() if _truth(pred) else else_func()
