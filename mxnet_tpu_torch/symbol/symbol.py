"""Symbol: the declarative graph-construction API.

Counterpart of ``mxnet_tpu/symbol/symbol.py``, whose graph model it keeps:
a Symbol is a list of entries ``(node, output index)`` of a small
expression DAG over the op registry of ``mx.nd``.  ``list_arguments``,
``list_auxiliary_states`` and ``list_outputs`` walk it in the JAX
package's order, ``tojson`` writes the JAX package's JSON byte for byte
(so each package loads the other's files), ``infer_shape`` derives the
parameters' shapes by per-op rules and the outputs' by running each op on
``meta`` tensors (``_infer.py``), and ``bind``/``simple_bind`` make an
``Executor`` that walks the DAG eagerly under torch autograd.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..ops.registry import get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones"]


# input slots that are auxiliary states (BatchNorm's moving statistics)
_AUX_PARAMS = ("moving_mean", "moving_var")

# ops whose extra outputs are statistics, not user outputs
_PRIMARY_OUTPUTS = {"BatchNorm": 1}


def _rnn_num_outputs(attrs):
    """RNN's heads follow ``state_outputs``: the output alone, or with the
    state (and the cell state for an LSTM)."""
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def _dtype_name(dtype):
    """A dtype as its numpy name (``"float32"``), bfloat16 included."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return str(onp.dtype(dtype))


class _SymNode:
    """One graph node: an op application, or a variable (``op`` None).

    ``attrs`` are the op's parameters, passed to it at evaluation;
    ``user_attrs`` are ``AttrScope``/``attr=`` strings (``ctx_group``,
    ``__lr_mult__``...), which ride on the node and its JSON and never
    reach the op."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "in_names",
                 "user_attrs")

    def __init__(self, op, name, attrs, inputs, in_names=None,
                 user_attrs=None):
        self.op = op
        self.name = name
        self.attrs = attrs or {}
        self.user_attrs = user_attrs or {}
        self.inputs = inputs  # list of (node, out_idx)
        if in_names is None and op is not None:
            from . import _input_params, _VARARG_OPS
            opdef = get_op(op)
            if opdef is not None and op not in _VARARG_OPS:
                # the inputs were made in signature order, gated by attrs
                in_names = _input_params(opdef, self.attrs)[:len(inputs)]
        self.in_names = in_names
        if op is None:
            self.num_outputs = 1
            return
        opdef = get_op(op)
        if opdef is None:  # vararg pseudo-op (Concat/add_n/stack)
            self.num_outputs = 1
        elif opdef.num_outputs == 0:  # variadic outputs (SliceChannel)
            self.num_outputs = int(self.attrs.get("num_outputs", 1))
        elif opdef.name == "RNN":
            self.num_outputs = _rnn_num_outputs(self.attrs)
        else:
            self.num_outputs = _PRIMARY_OUTPUTS.get(
                opdef.name, opdef.num_outputs)


class Symbol:
    """A symbolic handle on one or more outputs of a graph."""

    def __init__(self, entries: Sequence[Tuple[_SymNode, int]]):
        self._entries = list(entries)

    # -- composition helpers -------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def attr(self, key):
        if len(self._entries) == 1:
            node = self._entries[0][0]
            if key in node.user_attrs:
                return node.user_attrs[key]
            return node.attrs.get(key)
        return None

    def list_attr(self):
        node = self._entries[0][0]
        merged = dict(node.attrs)
        merged.update(node.user_attrs)
        return merged

    def attr_dict(self):
        """``{node name: its attributes}`` over the whole graph, what
        ``Module`` hands the initializer (``__init__``, ``__lr_mult__``)."""
        out = {}
        for node in self._topo():
            merged = dict(node.attrs)
            merged.update(node.user_attrs)
            if merged:
                out[node.name] = merged
        return out

    def __getitem__(self, index):
        if isinstance(index, str):
            for i, name in enumerate(self.list_outputs()):
                if name == index:
                    return Symbol([self._entries[i]])
            raise ValueError("no output named %r" % index)
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group")

    def get_internals(self):
        """A Symbol of every output of every node."""
        entries = []
        for node in self._topo():
            if node.op is None:
                entries.append((node, 0))
            else:
                for i in range(node.num_outputs):
                    entries.append((node, i))
        return Symbol(entries)

    def get_children(self):
        node = self._entries[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # -- traversal ------------------------------------------------------
    def _topo(self) -> List[_SymNode]:
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for child, _ in node.inputs:
                visit(child)
            order.append(node)

        for node, _ in self._entries:
            visit(node)
        return order

    def _aux_nodes(self):
        aux = []
        seen = set()
        for node in self._topo():
            if node.op is None or not node.in_names:
                continue
            for (child, _), pname in zip(node.inputs, node.in_names):
                if (pname in _AUX_PARAMS and child.op is None
                        and id(child) not in seen):
                    seen.add(id(child))
                    aux.append(child)
        return aux

    def list_arguments(self):
        """The free variables in depth-first order, auxiliary states
        left out."""
        aux_ids = {id(n) for n in self._aux_nodes()}
        return [n.name for n in self._topo()
                if n.op is None and id(n) not in aux_ids]

    def list_auxiliary_states(self):
        return [n.name for n in self._aux_nodes()]

    def list_outputs(self):
        outs = []
        for node, idx in self._entries:
            if node.op is None:
                outs.append(node.name)
            elif node.num_outputs == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    # -- arithmetic -----------------------------------------------------
    def _binop(self, other, op_name, scalar_op, rev=False):
        from . import _invoke_op
        if isinstance(other, Symbol):
            a, b = (other, self) if rev else (self, other)
            return _invoke_op(op_name, [a, b], {})
        return _invoke_op(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_rminus_scalar", rev=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", "_rdiv_scalar", rev=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return self.__mul__(-1.0)

    def __getattr__(self, name):
        # fluent op calls: s.reshape(...), s.sum(...)
        if name.startswith("_"):
            raise AttributeError(name)
        op = get_op(name)
        if op is None:
            raise AttributeError("Symbol has no attribute %r" % name)
        from . import _make_sym_func
        fn = _make_sym_func(op)

        def method(*args, **kwargs):
            return fn(self, *args, **kwargs)

        return method

    # -- shape/type inference ------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes of some
        arguments: parameters by the per-op rules, outputs by running each
        op on ``meta`` tensors.  Raises where the graph stays
        underdetermined."""
        return self._infer_shape_impl(args, kwargs, partial=False)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(args, kwargs, partial=True)

    def _infer_shape_impl(self, args, kwargs, partial):
        from ._infer import infer_graph_shapes
        known = {}
        if args:
            for name, shape in zip(self.list_arguments(), args):
                if shape is not None:
                    known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes = infer_graph_shapes(self, known, partial=partial)
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes.get(("out", id(node), idx))
                      for node, idx in self._entries]
        if not partial:
            unknown = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            if unknown or any(s is None for s in out_shapes):
                raise MXNetError(
                    "infer_shape: graph underdetermined; cannot infer "
                    "shapes of arguments %r (provide their shapes or more "
                    "input shapes, or use infer_shape_partial)" % (unknown,))
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """float32 for every argument, output and auxiliary state, as the
        JAX package types a graph; the bound arrays carry the real
        dtypes."""
        dt = onp.float32
        return ([dt] * len(self.list_arguments()), [dt] * len(self._entries),
                [dt] * len(self.list_auxiliary_states()))

    # -- serialization --------------------------------------------------
    def tojson(self):
        """The graph as the JAX package's JSON: ``nodes`` (every attribute
        value ``json.dumps``-ed), ``arg_nodes`` and ``heads``."""
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            all_attrs = dict(n.attrs)
            all_attrs.update(n.user_attrs)
            out_nodes.append({
                "op": n.op if n.op is not None else "null",
                "name": n.name,
                "attrs": {k: json.dumps(v) for k, v in all_attrs.items()},
                "inputs": [[nid[id(c)], i, 0] for c, i in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes) if n.op is None]
        heads = [[nid[id(n)], i, 0] for n, i in self._entries]
        return json.dumps({"nodes": out_nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10500]}},
                          indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` atomically: a temporary file
        in the same directory, then ``os.replace``, so a crash leaves the
        previous file whole."""
        from ..ndarray.utils import atomic_file
        with atomic_file(fname) as fh:
            fh.write(self.tojson().encode())

    # -- evaluation -----------------------------------------------------
    def eval_imperative(self, arg_dict):
        """Run the graph on NDArrays through the ``mx.nd`` dispatch
        (recorded under ``autograd.record()``): ``SymbolBlock`` and
        :meth:`eval` use it."""
        from .. import ndarray as nd

        values: Dict[Tuple[int, int], object] = {}
        for node in self._topo():
            if node.op is None:
                if node.name not in arg_dict:
                    raise MXNetError("missing argument %r" % node.name)
                values[(id(node), 0)] = arg_dict[node.name]
                continue
            ins = [values[(id(c), i)] for c, i in node.inputs]
            attrs = dict(node.attrs)
            if node.op in ("Concat", "concat"):
                out = nd.concat(*ins, dim=attrs.get("dim", 1))
            elif node.op in ("add_n", "ElementWiseSum", "elemwise_sum"):
                out = nd.add_n(*ins)
            elif node.op == "stack":
                out = nd.stack(*ins, axis=attrs.get("axis", 0))
            else:
                attrs.pop("num_args", None)
                out = getattr(nd, node.op)(*ins, **attrs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
        results = [values[(id(n), i)] for n, i in self._entries]
        return results if len(results) > 1 else results[0]

    def eval(self, ctx=None, **kwargs):
        """The outputs for the arrays ``kwargs``, as a list."""
        out = self.eval_imperative(kwargs)
        return out if isinstance(out, list) else [out]

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over arrays the caller made."""
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Infer the shapes from ``kwargs``, make zero arrays on ``ctx``
        and bind them."""
        from .. import ndarray as nd
        from ..executor import Executor
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        args = [nd.zeros(s, ctx=ctx) for s in arg_shapes]
        aux = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
        if grad_req != "null":
            args_grad = [nd.zeros(s, ctx=ctx) for s in arg_shapes]
        else:
            args_grad = None
        return Executor(self, ctx, args, args_grad, grad_req, aux)

    # -- subgraph backends ---------------------------------------------
    def get_backend_symbol(self, backend):
        """The graph rewritten by a registered subgraph property
        (``subgraph.py``); structure only."""
        from ..subgraph import optimize_for
        return optimize_for(self, backend)

    def optimize_for(self, backend, args=None, aux=None):
        """:meth:`get_backend_symbol` and the parameters rewritten to match
        (``(sym, args, aux)`` where ``args``/``aux`` are given)."""
        from ..subgraph import optimize_for
        return optimize_for(self, backend, args, aux)

    def var_names(self):
        return self.list_inputs()


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A symbolic variable."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    from .. import attribute as _attribute
    attrs = _attribute.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = _dtype_name(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    node = _SymNode(None, name, attrs, [])
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    """One Symbol of the outputs of ``symbols``, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def zeros(shape, dtype=None, **kwargs):
    from . import _invoke_op
    return _invoke_op("_zeros", [], {"shape": tuple(shape),
                                     "dtype": dtype or "float32"})


def ones(shape, dtype=None, **kwargs):
    from . import _invoke_op
    return _invoke_op("_ones", [], {"shape": tuple(shape),
                                    "dtype": dtype or "float32"})


_SIG_NAME_CACHE: Dict[str, object] = {}


def _op_sig_names(op_name):
    """The parameter names of a registered op's function (None for an
    unknown or vararg op): ``load_json`` splits metadata from them."""
    if op_name not in _SIG_NAME_CACHE:
        import inspect
        opdef = get_op(op_name)
        _SIG_NAME_CACHE[op_name] = (
            None if opdef is None
            else frozenset(inspect.signature(opdef.fn).parameters))
    return _SIG_NAME_CACHE[op_name]


def load_json(json_str):
    """A Symbol from graph JSON (this package's, the JAX package's, or
    MXNet's plain-string attributes)."""
    data = json.loads(json_str)
    nodes = []
    for spec in data["nodes"]:
        attrs = {}
        for k, v in spec.get("attrs", {}).items():
            if isinstance(v, str):
                try:
                    attrs[k] = json.loads(v)
                except (ValueError, TypeError):
                    attrs[k] = v
            else:
                attrs[k] = v
        # JSON gives lists back; ops take tuples
        attrs = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in attrs.items()}
        op = spec["op"]
        inputs = [(nodes[nid], out_idx) for nid, out_idx, _ in spec["inputs"]]
        user_attrs = {}
        if op != "null":
            # what the op's signature does not name is metadata
            sig_names = _op_sig_names(op)
            if sig_names is not None:
                user_attrs = {k: v for k, v in attrs.items()
                              if k not in sig_names}
                attrs = {k: v for k, v in attrs.items() if k in sig_names}
        node = _SymNode(None if op == "null" else op, spec["name"], attrs,
                        inputs, user_attrs=user_attrs)
        nodes.append(node)
    entries = [(nodes[nid], idx) for nid, idx, _ in data["heads"]]
    return Symbol(entries)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
