"""Executor: a bound Symbol graph, run eagerly under torch autograd.

Counterpart of ``mxnet_tpu/executor.py``, whose conventions it keeps; where
the JAX package jits one pure function of the DAG and takes its
``jax.vjp``, this Executor walks the DAG node by node, each node through its
registered op (``symbol/_eval.py``), on the executor's device:

* ``forward(is_train=True)`` with gradient arrays bound runs the walk with
  fresh leaves (the bound arrays' tensors, detached, requiring grad) for
  the arguments whose ``grad_req`` is not ``"null"``, and keeps the
  outputs for ``backward``; otherwise it runs under ``torch.no_grad()``;
* ``backward()`` is ``torch.autograd.grad`` of the outputs with respect to
  those leaves: with no ``out_grads`` every floating head gets a ones
  cotangent (``SoftmaxOutput`` and the regression outputs ignore it, as
  their backward is the loss's gradient), and each gradient is written to
  (``"write"``) or added to (``"add"``) its array; an argument the outputs
  do not depend on gets zeros, as from ``jax.vjp``;
* in training, the moving statistics of a node named ``BatchNorm`` (and of
  no other op, as in the JAX package) become ``aux * momentum + batch *
  (1 - momentum)``;
* a random node draws from the port's generator of the executor's device
  (``random.generator``).

``reshape`` makes an Executor for new input shapes that shares the arrays
whose shapes stay.  Capturing the walk as CUDA graphs waits (ROADMAP.md,
queue 1, item 6).
"""
from __future__ import annotations

from typing import List

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError
from .context import current_context
from .symbol import _is_random
from .symbol._eval import eval_node
from .ops.registry import get_op

__all__ = ["Executor"]


def _moving_stat_updates(node, outs, aux_map, training):
    """``{aux name: new value}`` of a ``BatchNorm`` node in training."""
    if node.op != "BatchNorm" or not node.in_names or not training \
            or node.attrs.get("use_global_stats", False):
        return {}
    mom = float(node.attrs.get("momentum", 0.9))
    batch = {"moving_mean": outs[1], "moving_var": outs[2]}
    new = {}
    for (c, _), pname in zip(node.inputs, node.in_names):
        if pname in batch and c.name in aux_map:
            new[c.name] = (aux_map[c.name] * mom
                           + batch[pname].detach() * (1.0 - mom))
    return new


class Executor:
    """A Symbol bound to argument, gradient and auxiliary arrays (made by
    ``Symbol.bind``/``simple_bind``)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def normalize(vals, names, what):
            if vals is None:
                return [None] * len(names)
            if isinstance(vals, dict):
                return [vals.get(n) for n in names]
            vals = list(vals)
            if len(vals) != len(names):
                raise MXNetError(
                    "Length of %s (%d) does not match number of names (%d)"
                    % (what, len(vals), len(names)))
            return vals

        self.arg_arrays = normalize(args, arg_names, "args")
        for n, a in zip(arg_names, self.arg_arrays):
            if a is None:
                raise MXNetError("argument %r is not bound" % n)
        self.aux_arrays = normalize(aux_states, aux_names, "aux_states")
        for n, a in zip(aux_names, self.aux_arrays):
            if a is None:
                raise MXNetError("auxiliary state %r is not bound" % n)
        self.grad_arrays = normalize(args_grad, arg_names, "args_grad")
        if isinstance(grad_req, str):
            reqs = [grad_req] * len(arg_names)
        elif isinstance(grad_req, dict):
            reqs = [grad_req.get(n, "null") for n in arg_names]
        else:
            reqs = list(grad_req)
        self._grad_req = ["null" if g is None else r
                          for r, g in zip(reqs, self.grad_arrays)]
        if ctx is None:
            first = (self.arg_arrays + self.aux_arrays)[:1]
            ctx = first[0].context if first else current_context()
        self._ctx = ctx
        self._device = self._ctx.torch_device

        self._arg_names = arg_names
        self._aux_names = aux_names
        self.arg_dict = dict(zip(arg_names, self.arg_arrays))
        self.aux_dict = dict(zip(aux_names, self.aux_arrays))
        self.grad_dict = dict(zip(arg_names, self.grad_arrays))
        self.outputs: List = []
        self._nodes = symbol._topo()
        self._random = [n.op is not None and get_op(n.op) is not None
                        and _is_random(get_op(n.op)) for n in self._nodes]
        self._pending = None

    # -- execution ------------------------------------------------------
    def _run(self, arg_vals, aux_vals, training):
        """The walk: ``(outputs, {aux name: new value})``."""
        arg_map = dict(zip(self._arg_names, arg_vals))
        aux_map = dict(zip(self._aux_names, aux_vals))
        new_aux = {}
        env = {}
        gen = _random.generator(self._device)
        with self._ctx:
            for node, rnd in zip(self._nodes, self._random):
                if node.op is None:
                    if node.name in arg_map:
                        env[(id(node), 0)] = arg_map[node.name]
                    elif node.name in aux_map:
                        env[(id(node), 0)] = aux_map[node.name]
                    else:
                        raise MXNetError("unbound variable %r" % node.name)
                    continue
                ins = [env[(id(c), i)] for c, i in node.inputs]
                outs = eval_node(node, ins, gen if rnd else None, training)
                new_aux.update(_moving_stat_updates(node, outs, aux_map,
                                                    training))
                for i, o in enumerate(outs):
                    env[(id(node), i)] = o
        outs = [env[(id(n), i)] for n, i in self._symbol._entries]
        return outs, new_aux

    def forward(self, is_train=False, **kwargs):
        """Run the graph; keyword arrays are first copied into the bound
        arguments of those names (onto the executor's device, in the bound
        array's dtype)."""
        from .ndarray.ndarray import _wrap

        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError("unknown input %r" % name)
            dst = self.arg_dict[name]
            dst._data = val._data.to(device=dst._data.device,
                                     dtype=dst._data.dtype)
        diff_idx = [i for i, r in enumerate(self._grad_req)
                    if r != "null" and self.grad_arrays[i] is not None]
        aux_vals = [a._data for a in self.aux_arrays]
        if is_train and diff_idx:
            leaves = [self.arg_arrays[i]._data.detach().requires_grad_()
                      for i in diff_idx]
            arg_vals = [a._data for a in self.arg_arrays]
            for i, leaf in zip(diff_idx, leaves):
                arg_vals[i] = leaf
            with torch.enable_grad():
                outs, new_aux = self._run(arg_vals, aux_vals, True)
            self._pending = (outs, leaves, diff_idx)
        else:
            with torch.no_grad():
                outs, new_aux = self._run([a._data for a in self.arg_arrays],
                                          aux_vals, bool(is_train))
            self._pending = None
        if is_train:
            for name, a in self.aux_dict.items():
                if name in new_aux:
                    a._data = new_aux[name].detach().to(a._data.dtype)
        self.outputs = [_wrap(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Write or add the gradients of the bound arguments, from ones
        for every floating head or from ``out_grads``."""
        if self._pending is None:
            raise MXNetError(
                "backward() requires a prior forward(is_train=True) with "
                "gradient arrays bound")
        outs, leaves, diff_idx = self._pending
        if out_grads is None:
            cots = [torch.ones_like(o) if o.is_floating_point() else None
                    for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [g._data if hasattr(g, "_data")
                    else torch.as_tensor(g, device=o.device)
                    for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cots)
                 if c is not None and o.requires_grad]
        grads = [None] * len(leaves)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                        [c.to(o.dtype) for o, c in pairs],
                                        allow_unused=True)
        for i, g in zip(diff_idx, grads):
            if g is None:
                g = torch.zeros_like(leaves[diff_idx.index(i)])
            dst = self.grad_arrays[i]
            if self._grad_req[i] == "add":
                dst._data = dst._data + g
            else:
                dst._data = g

    # -- parameter management ------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: NDArray}`` into the bound arguments (and auxiliary
        states), in their dtypes and on their devices."""
        def copy(dst, src):
            dst._data = src._data.to(device=dst._data.device,
                                     dtype=dst._data.dtype, copy=True)

        for name, arr in arg_params.items():
            if name in self.arg_dict:
                copy(self.arg_dict[name], arr)
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in arguments" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                copy(self.aux_dict[name], arr)
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in aux states" % name)

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """An Executor for new input shapes, as the JAX package's:

        * an argument not named in ``kwargs`` whose inferred shape changes
          raises unless ``partial_shaping``;
        * a larger array raises unless ``allow_up_sizing`` (and is then new
          zeros);
        * an argument whose shape stays shares its NDArray, and a same-size
          or smaller one is a view of the existing values."""
        from . import ndarray as nd
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def remake(name, shape, cur, specified):
            new_size = int(onp.prod(shape)) if shape else 1
            cur_size = int(onp.prod(cur.shape)) if cur.shape else 1
            if not specified and not partial_shaping:
                raise MXNetError(
                    "Executor.reshape: shape of unspecified argument %r "
                    "changed %s -> %s; pass partial_shaping=True to allow"
                    % (name, tuple(cur.shape), shape))
            if new_size > cur_size:
                if not allow_up_sizing:
                    raise MXNetError(
                        "Executor.reshape: argument %r grows %s -> %s; "
                        "pass allow_up_sizing=True to allocate a larger "
                        "array" % (name, tuple(cur.shape), shape))
                return nd.zeros(shape, ctx=self._ctx, dtype=cur.dtype)
            flat = cur.reshape((cur_size,))
            if new_size < cur_size:
                flat = flat[:new_size]
            return flat.reshape(shape)

        args, grads = [], []
        for name, shape, cur, grad in zip(self._arg_names, arg_shapes,
                                          self.arg_arrays, self.grad_arrays):
            if shape == tuple(cur.shape):
                args.append(cur)
                grads.append(grad)
            else:
                args.append(remake(name, shape, cur, name in kwargs))
                grads.append(nd.zeros(shape, ctx=self._ctx, dtype=cur.dtype)
                             if grad is not None else None)
        aux = [cur if tuple(cur.shape) == shape
               else remake(name, shape, cur, True)
               for (shape, cur, name) in zip(aux_shapes, self.aux_arrays,
                                             self._aux_names)]
        return Executor(self._symbol, self._ctx, args, grads,
                        self._grad_req, aux)
