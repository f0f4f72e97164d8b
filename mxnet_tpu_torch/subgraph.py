"""Subgraph properties: named graph-rewrite passes over the Symbol DAG.

Counterpart of ``mxnet_tpu/subgraph.py`` (the reference's subgraph
framework, ``SubgraphProperty`` and its registry).  A property matches
node chains of a Symbol, rewrites the graph and knows how to transform the
bound parameters to match.  The one shipped is ``CONV_BN_FOLD``, the
inference fold of BatchNorm into the Convolution before it: BatchNorm's
affine over its moving statistics goes into the convolution's weight and
bias, and the BatchNorm nodes go away::

    fused = sym.get_backend_symbol("CONV_BN_FOLD")          # structure only
    fused, args, aux = subgraph.optimize_for(sym, "CONV_BN_FOLD",
                                             args, aux)     # + parameters

Properties register by name with ``@subgraph.register_subgraph_property``.
"""
from __future__ import annotations

from typing import Dict

import numpy as onp

from .base import MXNetError

__all__ = ["SubgraphProperty", "register_subgraph_property",
           "get_subgraph_property", "list_subgraph_properties",
           "optimize_for", "ConvBNFoldProperty"]

_PROPERTIES: Dict[str, type] = {}


def register_subgraph_property(name):
    """Class decorator: register a SubgraphProperty under ``name``
    (reference MXNET_REGISTER_SUBGRAPH_PROPERTY, subgraph_property.h:488)."""
    def wrap(cls):
        _PROPERTIES[name.upper()] = cls
        cls.backend_name = name.upper()
        return cls
    return wrap


def get_subgraph_property(name) -> "SubgraphProperty":
    cls = _PROPERTIES.get(str(name).upper())
    if cls is None:
        raise MXNetError(
            "unknown subgraph property %r (registered: %s)"
            % (name, sorted(_PROPERTIES)))
    return cls()


def list_subgraph_properties():
    return sorted(_PROPERTIES)


class SubgraphProperty:
    """One graph-rewrite pass (reference subgraph_property.h:206).

    Subclasses implement ``apply(sym) -> Symbol`` (structural rewrite;
    may record planned parameter transforms on ``self``) and optionally
    ``convert_params(args, aux) -> (args, aux)`` to produce the parameter
    dictionaries matching the rewritten graph.
    """

    backend_name = None

    def apply(self, sym):
        raise NotImplementedError

    def convert_params(self, args, aux):
        return dict(args), dict(aux)


def optimize_for(sym, backend, args=None, aux=None):
    """Rewrite ``sym`` with the named property; when ``args``/``aux`` are
    given, also fold the parameter values (returns (sym, args, aux)).
    The reference's two-step equivalent is get_backend_symbol() plus the
    backend's in-C weight rewrite at bind time."""
    prop = get_subgraph_property(backend)
    new_sym = prop.apply(sym)
    if args is None and aux is None:
        return new_sym
    new_args, new_aux = prop.convert_params(dict(args or {}), dict(aux or {}))
    return new_sym, new_args, new_aux


# ---------------------------------------------------------------------------
# the shipped pass: inference conv+BN fold
# ---------------------------------------------------------------------------

class _Fold:
    """Bookkeeping for one folded conv+BN pair."""

    __slots__ = ("weight", "bias", "gamma", "beta", "mean", "var",
                 "new_weight", "new_bias", "eps", "fix_gamma")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


@register_subgraph_property("CONV_BN_FOLD")
class ConvBNFoldProperty(SubgraphProperty):
    """Fold inference BatchNorm into the preceding Convolution
    (reference: the mkldnn conv property's conv+BN fusion,
    ``src/operator/subgraph/mkldnn/mkldnn_conv_property.h``; weight
    rewrite as in ``mkldnn_conv.cc``'s UpdateConvWeightBias).

    Inference-only: BN is replaced by its moving-stats affine, collapsed
    into conv weight/bias::

        W' = W * gamma / sqrt(var + eps)        (per out-channel)
        b' = beta + (b - mean) * gamma / sqrt(var + eps)

    The rewritten graph has no BatchNorm nodes; new variables
    ``<conv>_folded_weight`` / ``<conv>_folded_bias`` replace the conv's
    weight/bias and BN's four parameters.  Do not train through the
    rewritten graph.
    """

    _CONV_OPS = ("Convolution", "convolution", "Convolution_v1")
    _BN_OPS = ("BatchNorm", "batch_norm", "BatchNorm_v1")

    def __init__(self):
        self.folds = []

    # -- structural rewrite --------------------------------------------
    def apply(self, sym):
        from .symbol.symbol import Symbol, _SymNode

        self.folds = []   # re-applying one property instance starts fresh
        nodes = sym._topo()
        consumers: Dict[tuple, int] = {}
        for n in nodes:
            for c, i in n.inputs:
                key = (id(c), i)
                consumers[key] = consumers.get(key, 0) + 1
        for n, i in sym._entries:
            key = (id(n), i)
            consumers[key] = consumers.get(key, 0) + 1

        def foldable(node):
            """BN whose data input is a single-consumer Convolution with
            variable weight/bias, and whose own params are variables."""
            if node.op not in self._BN_OPS or not node.inputs:
                return None
            conv, idx = node.inputs[0]
            if conv.op not in self._CONV_OPS or idx != 0:
                return None
            if consumers.get((id(conv), 0), 0) != 1:
                return None
            # BN's batch-stats outputs must be unused
            if any(consumers.get((id(node), i), 0) for i in (1, 2)):
                return None
            if any(c.op is not None for c, _ in node.inputs[1:]):
                return None
            if any(c.op is not None for c, _ in conv.inputs[1:]):
                return None
            return conv

        rebuilt: Dict[int, _SymNode] = {}

        def rebuild(node):
            got = rebuilt.get(id(node))
            if got is not None:
                return got
            conv = foldable(node)
            if conv is not None:
                data_node, data_idx = conv.inputs[0]
                new_data = rebuild(data_node)
                w_var = _SymNode(None, conv.name + "_folded_weight", {}, [])
                b_var = _SymNode(None, conv.name + "_folded_bias", {}, [])
                attrs = dict(conv.attrs)
                attrs["no_bias"] = False
                new_node = _SymNode(conv.op, conv.name, attrs,
                                    [(new_data, data_idx), (w_var, 0),
                                     (b_var, 0)])
                bn_names = [c.name for c, _ in node.inputs[1:]]
                conv_bias = None
                if not conv.attrs.get("no_bias", False) \
                        and len(conv.inputs) > 2:
                    conv_bias = conv.inputs[2][0].name
                self.folds.append(_Fold(
                    weight=conv.inputs[1][0].name, bias=conv_bias,
                    gamma=bn_names[0], beta=bn_names[1],
                    mean=bn_names[2], var=bn_names[3],
                    new_weight=w_var.name, new_bias=b_var.name,
                    eps=float(node.attrs.get("eps", 1e-3)),
                    fix_gamma=bool(node.attrs.get("fix_gamma", True))))
                rebuilt[id(node)] = new_node
                return new_node
            new_inputs = [(rebuild(c), i) for c, i in node.inputs]
            if node.op is None and not node.inputs:
                new_node = node     # variables are shared, not copied
            else:
                new_node = _SymNode(node.op, node.name, dict(node.attrs),
                                    new_inputs, in_names=node.in_names)
            rebuilt[id(node)] = new_node
            return new_node

        entries = [(rebuild(n), i) for n, i in sym._entries]
        return Symbol(entries)

    # -- parameter rewrite ---------------------------------------------
    def convert_params(self, args, aux):
        from . import ndarray as nd

        def asnp(x):
            return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)

        ctx = next((v.context for v in list(args.values())
                    + list(aux.values()) if hasattr(v, "context")), None)

        args = dict(args)
        aux = dict(aux)
        for f in self.folds:
            W = asnp(args.pop(f.weight)).astype(onp.float64)
            beta = asnp(args.pop(f.beta)).astype(onp.float64)
            gamma_arr = args.pop(f.gamma, None)
            gamma = (onp.ones_like(beta) if f.fix_gamma or gamma_arr is None
                     else asnp(gamma_arr).astype(onp.float64))
            mean = asnp(aux.pop(f.mean)).astype(onp.float64)
            var = asnp(aux.pop(f.var)).astype(onp.float64)
            b = (asnp(args.pop(f.bias)).astype(onp.float64)
                 if f.bias else onp.zeros_like(beta))
            scale = gamma / onp.sqrt(var + f.eps)
            w_new = W * scale.reshape((-1,) + (1,) * (W.ndim - 1))
            b_new = beta + (b - mean) * scale
            args[f.new_weight] = nd.array(w_new.astype(onp.float32), ctx=ctx)
            args[f.new_bias] = nd.array(b_new.astype(onp.float32), ctx=ctx)
        return args, aux
