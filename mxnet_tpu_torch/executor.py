"""Executor: a bound Symbol graph, captured as CUDA graphs.

Counterpart of ``mxnet_tpu/executor.py``, whose conventions it keeps; where
the JAX package jits one pure function of the DAG and takes its
``jax.vjp``, this Executor walks the DAG node by node, each node through its
registered op (``symbol/_eval.py``), on the executor's device, and
captures that walk (``cuda_graph``), one graph or pair of graphs per key:
``is_train``, the bound arrays' shapes and dtypes, ``grad_req`` and the
storage of the bound arrays, which are the graphs' static inputs:

* ``forward`` copies keyword feeds into the bound arrays (a feed of
  another shape replaces its array, and the next call captures anew);
* ``forward(is_train=True)`` with gradient arrays bound replays the
  forward of a pair (``cuda_graph.CapturedPair``), differentiated against
  the arguments whose ``grad_req`` is not ``"null"``, and keeps it for
  ``backward``; otherwise it replays a forward graph (``Captured``);
* ``backward()`` replays the pair's backward on the head gradients: with
  no ``out_grads`` every floating head gets a ones cotangent
  (``SoftmaxOutput`` and the regression outputs ignore it, as their
  backward is the loss's gradient), and each gradient is written to
  (``"write"``) or added to (``"add"``) its array in place; an argument
  the outputs do not depend on gets zeros, as from ``jax.vjp``;
* in training, the moving statistics of a node named ``BatchNorm`` (and of
  no other op, as in the JAX package) become ``aux * momentum + batch *
  (1 - momentum)``, written into the bound auxiliary arrays by the graph;
* a random node draws from the port's generator of the executor's device
  (``random.generator``), registered with the graphs: each replay draws
  anew.

Each Executor keeps its own graphs, from a pool of its own (and each
pair from one of its own), where the JAX package's reshaped executors
share one jit: ``reshape`` makes an Executor for new input shapes that
shares the arrays whose shapes stay and captures graphs of its own
(``Module`` keeps its executors by shape, so a batch of an earlier shape
finds them).  A training forward reads the arguments it does not
differentiate (the data, the labels) through copies of its own, which its
backward reads: a feed between a forward and its backward (into an array
that a same-shape reshape shares) leaves that backward as it was, as the
JAX package's vjp keeps the values its forward saw.  The differentiated
arguments are read in place (writes into bound arrays are in place, so
that the graphs' static inputs keep their storage), so ``backward``
raises when one of them was written since the forward (a copy into a
weight), where the JAX package differentiates the forward's values.  On
the CPU each call runs the walk (with autograd for a pair), the same
protocol without the capture.
"""
from __future__ import annotations

from typing import List

import numpy as onp
import torch

from . import random as _random
from . import telemetry
from .base import MXNetError
from .cuda_graph import Captured, CapturedPair, enabled, new_pool, \
    storage_key
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
        # {key: (storage, Captured or CapturedPair)}, and the pool of the
        # forward-only graphs (a pair has its own)
        self._graphs = {}
        self._pool = None

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
            src = val._data if hasattr(val, "_data") else torch.as_tensor(val)
            if tuple(src.shape) == tuple(dst._data.shape):
                with torch.no_grad():
                    dst._data.copy_(src)
            else:
                dst._data = src.to(device=dst._data.device,
                                   dtype=dst._data.dtype)
        diff_idx = [i for i, r in enumerate(self._grad_req)
                    if r != "null" and self.grad_arrays[i] is not None]
        self._pending = None
        if is_train and diff_idx:
            pair = self._pair(diff_idx)
            outs, gen = pair.forward([])
            self._pending = (pair, gen, diff_idx, self._versions(diff_idx))
        else:
            outs = self._entry(bool(is_train))([])
        self.outputs = [_wrap(o) for o in outs]
        return self.outputs

    def _versions(self, diff_idx):
        # torch's count of in-place writes of each differentiated argument
        return tuple(self.arg_arrays[i]._data._version for i in diff_idx)

    def _sig(self, is_train, pair):
        arrays = self.arg_arrays + self.aux_arrays
        return (is_train, pair, tuple(self._grad_req) if pair else None,
                tuple((tuple(a.shape), str(a._data.dtype)) for a in arrays))

    def _lookup(self, key, make, doc):
        if not enabled():
            # cuda_graph.disabled(): a body run eagerly, neither kept nor
            # reported
            return make()
        arrays = self.arg_arrays + self.aux_arrays
        storage = storage_key([a._data for a in arrays])
        hit = self._graphs.get(key)
        if hit is None or hit[0] != storage:
            hit = self._graphs[key] = (storage, make())
            telemetry.record_compile(
                "Executor[%x]" % id(self),
                dict(doc, arrays=[{"shape": list(a.shape),
                                   "dtype": str(a._data.dtype)}
                                  for a in arrays]))
        return hit[1]

    def _gens(self):
        return (_random.generator(self._device),) \
            if self._device.type == "cuda" else ()

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for name, a in self.aux_dict.items():
                if name in new_aux:
                    a._data.copy_(new_aux[name].detach())

    def _entry(self, is_train):
        """The forward graph of ``is_train`` (the moving statistics written
        in training)."""
        def body(_):
            with torch.no_grad():
                outs, new_aux = self._run([a._data for a in self.arg_arrays],
                                          [a._data for a in self.aux_arrays],
                                          is_train)
                if is_train:
                    self._write_aux(new_aux)
            return outs

        def make():
            if self._pool is None:
                self._pool = new_pool(self._device)
            return Captured(body, [], pool=self._pool,
                            generators=self._gens(), device=self._device)
        return self._lookup(self._sig(is_train, False), make,
                            {"is_train": is_train})

    def _pair(self, diff_idx):
        """The forward and backward pair of a training forward."""
        def body(_, leaves):
            # the other arguments through copies, which the backward reads
            # whatever is fed after the forward
            diff = dict(zip(diff_idx, leaves))
            arg_vals = [diff[i] if i in diff else a._data.clone()
                        for i, a in enumerate(self.arg_arrays)]
            outs, new_aux = self._run(arg_vals,
                                      [a._data for a in self.aux_arrays],
                                      True)
            self._write_aux(new_aux)
            return outs

        def make():
            return CapturedPair(body, [], [], [self.arg_arrays[i]._data
                                               for i in diff_idx],
                                generators=self._gens(),
                                state=[a._data for a in self.aux_arrays])
        return self._lookup(self._sig(True, True), make,
                            {"is_train": True,
                             "grad_req": list(self._grad_req)})

    def backward(self, out_grads=None, is_train=True):
        """Write or add the gradients of the bound arguments, from ones
        for every floating head or from ``out_grads``."""
        if self._pending is None:
            raise MXNetError(
                "backward() requires a prior forward(is_train=True) with "
                "gradient arrays bound")
        pair, gen, diff_idx, versions = self._pending
        if versions != self._versions(diff_idx):
            raise MXNetError(
                "backward(): an argument it differentiates was written "
                "after the forward (a copy into a weight); call forward "
                "again")
        outs = self.outputs
        if out_grads is None:
            cots = [torch.ones_like(o._data) if o._data.is_floating_point()
                    else None for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [g._data if hasattr(g, "_data")
                    else torch.as_tensor(g, device=o._data.device)
                    for g, o in zip(out_grads, outs)]
        grads = pair.backward(gen, cots)
        with torch.no_grad():
            for i, g in zip(diff_idx, grads):
                dst = self.grad_arrays[i]._data
                if self._grad_req[i] == "add":
                    if g is not None:
                        dst.add_(g)
                elif g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)

    # -- parameter management ------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: NDArray}`` into the bound arguments (and auxiliary
        states), in their dtypes and on their devices."""
        def copy(dst, src):
            if tuple(src.shape) == tuple(dst._data.shape):
                with torch.no_grad():
                    dst._data.copy_(src._data)
            else:
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
