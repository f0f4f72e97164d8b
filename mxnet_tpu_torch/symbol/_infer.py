"""Graph shape inference for Symbol.

Counterpart of ``mxnet_tpu/symbol/_infer.py``.  A parameter's shape comes
from the data shape of the op that takes it, by the per-op rules below
(copied from the JAX package).  An output's shape comes from running the
node's op on ``meta`` tensors, which carry a shape and a dtype and no data,
where the JAX package runs ``jax.eval_shape``: every input is float32
there, as there.  The kernel wrappers take ``meta`` tensors through a rule
of their own that returns outputs of the right shape and dtype
(``ops/fused_norm.py``, ``ops/layernorm.py``, ``ops/attention.py``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..base import MXNetError


def _prod(t):
    p = 1
    for v in t:
        p *= v
    return p


def _norm_axis(axis, ndim):
    return axis % ndim


# -- parameter-shape rules ----------------------------------------------
# rule(attrs, names, shapes) -> {param name: shape}; ``shapes`` is
# parallel to ``node.in_names``, None where unknown.

def _data(names, shapes):
    return shapes[names.index("data")] if "data" in names else None


def _fc_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    nh = int(attrs.get("num_hidden", 0))
    flatten = attrs.get("flatten", True)
    in_dim = _prod(d[1:]) if (flatten and len(d) > 2) else d[-1]
    return {"weight": (nh, in_dim), "bias": (nh,)}


def _conv_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    k = tuple(attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    return {"weight": (nf, d[1] // ng) + k, "bias": (nf,)}


def _deconv_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    k = tuple(attrs.get("kernel", ()))
    nf = int(attrs.get("num_filter", 0))
    ng = int(attrs.get("num_group", 1))
    return {"weight": (d[1], nf // ng) + k, "bias": (nf,)}


def _channel_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    axis = _norm_axis(int(attrs.get("axis", 1)), len(d))
    c = (d[axis],)
    return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}


def _layernorm_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    axis = _norm_axis(int(attrs.get("axis", -1)), len(d))
    c = (d[axis],)
    return {"gamma": c, "beta": c}


def _instancenorm_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    c = (d[1],)
    return {"gamma": c, "beta": c}


def _embedding_rule(attrs, names, shapes):
    return {"weight": (int(attrs.get("input_dim", 0)),
                       int(attrs.get("output_dim", 0)))}


def _prelu_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    return {"gamma": (d[1] if len(d) > 1 else d[0],)}


def _softmax_out_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    if attrs.get("multi_output", False):
        return {"label": (d[0],) + tuple(d[2:])}
    return {"label": tuple(d[:-1])}


def _regression_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    return {"label": tuple(d)}


def _rnn_rule(attrs, names, shapes):
    d = _data(names, shapes)
    if d is None:
        return {}
    from ..ops.rnn import rnn_param_size
    h = int(attrs.get("state_size", 0))
    nl = int(attrs.get("num_layers", 1))
    bi = bool(attrs.get("bidirectional", False))
    mode = attrs.get("mode", "lstm")
    dirs = 2 if bi else 1
    n = rnn_param_size(nl, d[2], h, bi, mode)
    st = (nl * dirs, d[1], h)
    return {"parameters": (n,), "state": st, "state_cell": st}


# ``_contrib_BatchNormAddRelu`` has no rule, as in the JAX package: a graph
# that uses it leaves its gamma and beta underdetermined
_PARAM_RULES = {
    "FullyConnected": _fc_rule,
    "Convolution": _conv_rule,
    "Deconvolution": _deconv_rule,
    "BatchNorm": _channel_rule,
    "InstanceNorm": _instancenorm_rule,
    "GroupNorm": _channel_rule,
    "LayerNorm": _layernorm_rule,
    "Embedding": _embedding_rule,
    "LeakyReLU": _prelu_rule,
    "SoftmaxOutput": _softmax_out_rule,
    "LinearRegressionOutput": _regression_rule,
    "MAERegressionOutput": _regression_rule,
    "LogisticRegressionOutput": _regression_rule,
    "RNN": _rnn_rule,
}


_SHAPE_PRESERVING = ("amp_cast", "cast", "Cast", "BlockGrad", "block_grad",
                     "identity", "_copy", "stop_gradient", "make_loss")


def _through_casts(node):
    """The variable under shape-preserving unary wrappers (``amp_cast``...)
    of ``node``, or None where the path ends at an op."""
    while node.op in _SHAPE_PRESERVING and len(node.inputs) == 1:
        node = node.inputs[0][0]
    return node if node.op is None else None


def _abstract_out_shapes(node, in_shapes):
    """The output shapes of ``node``'s op on float32 ``meta`` inputs."""
    from ._eval import eval_node
    ins = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
           for s in in_shapes]
    with torch.no_grad():
        out = eval_node(node, ins, torch.Generator(), False)
    return [tuple(o.shape) for o in out]


def infer_graph_shapes(symbol, known: Dict[str, Tuple[int, ...]],
                       partial: bool = False):
    """Shapes propagated forward and backward over the DAG: ``{var name:
    shape}`` and ``{("out", id(node), idx): shape}``; an undetermined
    entry is absent."""
    shapes: Dict[object, Tuple[int, ...]] = {}
    nodes = symbol._topo()
    for node in nodes:
        if node.op is None:
            if node.name in known:
                shapes[node.name] = tuple(known[node.name])
            elif "__shape__" in node.attrs:
                shapes[node.name] = tuple(node.attrs["__shape__"])

    changed = True
    while changed:
        changed = False
        for node in nodes:
            if node.op is None:
                continue
            in_keys = [(c.name if c.op is None else ("out", id(c), i))
                       for c, i in node.inputs]
            in_shapes = [shapes.get(k) for k in in_keys]
            # backward into default-less variable inputs, seen through
            # shape-preserving wrappers such as amp_cast
            rule = _PARAM_RULES.get(node.op)
            if rule is not None and node.in_names:
                derived = rule(node.attrs, node.in_names, in_shapes)
                for (c, _), pname, cur in zip(node.inputs, node.in_names,
                                              in_shapes):
                    var = _through_casts(c)
                    if cur is None and var is not None \
                            and var.name not in shapes \
                            and pname in derived:
                        shapes[var.name] = tuple(int(v) for v in
                                                 derived[pname])
                        changed = True
                in_shapes = [shapes.get(k) for k in in_keys]
            out_key0 = ("out", id(node), 0)
            if out_key0 not in shapes and all(s is not None
                                              for s in in_shapes):
                try:
                    outs = _abstract_out_shapes(node, in_shapes)
                except Exception as e:  # inconsistent shapes
                    raise MXNetError(
                        "Error in operator %s: %s" % (node.name, e)) from None
                for i, s in enumerate(outs):
                    shapes[("out", id(node), i)] = s
                changed = True

    for node, idx in symbol._entries:
        if node.op is None and node.name in shapes:
            shapes[("out", id(node), idx)] = shapes[node.name]
    return shapes
