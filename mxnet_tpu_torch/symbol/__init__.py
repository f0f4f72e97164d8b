"""``mx.sym``: the declarative Symbol API over the op registry.

Counterpart of ``mxnet_tpu/symbol/__init__.py``.  ``mx.sym.<op>`` resolves
lazily (PEP 562 ``__getattr__``) against the registry behind ``mx.nd``, so
every op of the port can be a graph node.  An op's input slots and
attributes come from its function's signature, read as the JAX package
reads it: default-less parameters and the learnable/label names with a
None default are inputs, the rest attributes.  The port's samplers take a
``torch.Generator`` as ``gen`` where the JAX package's take a PRNG
``key``; the symbol layer skips both.  A node is random where its op draws
from the port's generator: the ``needs_rng`` ops, and ``Dropout`` and
``RNN``, which draw from it inside (the JAX package flags them
``needs_rng``).
"""
from __future__ import annotations

import inspect

from ..ops.registry import get_op, list_ops
from .symbol import (  # noqa: F401
    Symbol, var, Variable, Group, load, load_json, zeros, ones,
    _SymNode,
)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones"]


# Optional learnable/label inputs made as variables when omitted.
_OPTIONAL_INPUTS = ("weight", "bias", "gamma", "beta",
                    "moving_mean", "moving_var", "label", "state_cell")

# parameters threaded at run time, never user slots: the JAX package's
# ``key``, the port's ``gen``, and ``training``
_RUNTIME_PARAMS = ("key", "gen", "training")

# ops that draw from the port's generator inside, without a ``gen``
# parameter
_DRAWS_INSIDE = ("Dropout", "RNN")


def _is_random(op):
    """Whether a node of ``op`` draws random numbers."""
    return op.needs_rng or op.name in _DRAWS_INSIDE


def _gate(op_name, param, attrs):
    """Whether the optional input ``param`` exists under ``attrs``
    (Convolution's bias vanishes under ``no_bias``...)."""
    if param == "bias":
        return not attrs.get("no_bias", _default_no_bias(op_name))
    if param == "gamma" and op_name == "LeakyReLU":
        return attrs.get("act_type", "leaky") == "prelu"
    if param == "state_cell":
        return attrs.get("mode", "lstm") == "lstm"
    return True


def _default_no_bias(op_name):
    return op_name == "Deconvolution"


_INPUT_CACHE = {}


def _user_params(op):
    return [p for p in inspect.signature(op.fn).parameters.values()
            if p.name not in _RUNTIME_PARAMS
            and p.kind not in (inspect.Parameter.VAR_POSITIONAL,
                               inspect.Parameter.VAR_KEYWORD)]


def _sig_params(op):
    """Every user-facing parameter name of ``op.fn``, in signature
    order."""
    return [p.name for p in _user_params(op)]


def _sig_input_params(op):
    """The parameter names of ``op.fn`` that are array inputs: the
    default-less ones, and the learnable/label names defaulting to
    None."""
    cached = _INPUT_CACHE.get(op.name)
    if cached is not None:
        return cached
    names = [p.name for p in _user_params(op)
             if p.default is inspect.Parameter.empty
             or (p.default is None and p.name in _OPTIONAL_INPUTS)]
    _INPUT_CACHE[op.name] = names
    return names


def _input_params(op, attrs):
    """The input slots that exist under ``attrs`` (gated)."""
    return [n for n in _sig_input_params(op) if _gate(op.name, n, attrs)]


# ops taking a variadic list of inputs (no fixed signature slots)
_VARARG_OPS = {"Concat", "concat", "add_n", "ElementWiseSum",
               "elemwise_sum", "stack"}


def _hint(op_name):
    return op_name.lower().replace(".", "_").lstrip("_")


def _invoke_op(op_name, inputs, attrs, name=None, in_names=None,
               user_attrs=None):
    """A Symbol node applying ``op_name`` to the input Symbols."""
    from .. import attribute as _attribute
    from .. import name as _name_mod

    op = get_op(op_name)
    if op is None and op_name not in _VARARG_OPS:
        raise ValueError("unknown op %r" % op_name)
    if name is None:
        name = _name_mod.current().get(
            None, _hint(op.name if op is not None else op_name))
    scoped = _attribute.current().get(user_attrs)
    entries = [s._entries[0] for s in inputs]
    node = _SymNode(op_name, name, dict(attrs), entries,
                    in_names=in_names, user_attrs=scoped)
    return Symbol([(node, i) for i in range(node.num_outputs)])


_SYM_FUNC_CACHE = {}


def _make_sym_func(op):
    """The ``mx.sym.<op>`` wrapper: Symbol arguments become inputs, and a
    learnable input left out becomes a variable ``{name}_{param}``."""
    cached = _SYM_FUNC_CACHE.get(op.name)
    if cached is not None:
        return cached

    def func(*args, **kwargs):
        from .. import name as _name_mod

        name = kwargs.pop("name", None)
        user_attr = kwargs.pop("attr", None)
        name = _name_mod.current().get(name, _hint(op.name))
        attrs = {}
        given = {}
        # positional arguments follow the whole signature: a Symbol takes
        # the next input slot, anything else the next attribute slot
        params = _sig_params(op)
        input_set = set(_sig_input_params(op))
        if len(args) > len(params):
            raise TypeError("%s takes at most %d arguments (%d given)"
                            % (op.name, len(params), len(args)))
        pi = 0
        for a in args:
            if isinstance(a, Symbol):
                while pi < len(params) and params[pi] not in input_set:
                    pi += 1
                if pi == len(params):
                    raise TypeError("too many Symbol inputs for op %s"
                                    % op.name)
                given[params[pi]] = a
            else:
                while pi < len(params) and params[pi] in input_set:
                    pi += 1
                if pi == len(params):
                    raise TypeError("too many attribute arguments for op %s"
                                    % op.name)
                if a is not None:
                    attrs[params[pi]] = a
            pi += 1
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                given[k] = v
            elif v is not None:
                attrs[k] = v
        inputs, in_names = [], []
        for pname in _input_params(op, attrs):
            if pname in given:
                inputs.append(given.pop(pname))
                in_names.append(pname)
            elif pname in _OPTIONAL_INPUTS:
                inputs.append(var("%s_%s" % (name, pname)))
                in_names.append(pname)
        if given:
            raise TypeError("unexpected Symbol arguments %r for op %s"
                            % (sorted(given), op.name))
        return _invoke_op(op.name, inputs, attrs, name=name,
                          in_names=in_names, user_attrs=user_attr)

    func.__name__ = op.name
    func.__doc__ = op.doc
    _SYM_FUNC_CACHE[op.name] = func
    return func


def Concat(*args, dim: int = 1, name=None, **kwargs):
    """Concatenation of any number of inputs along ``dim``."""
    num_args = kwargs.pop("num_args", None)
    return _invoke_op("Concat", list(args),
                      {"dim": dim, "num_args": num_args or len(args)},
                      name=name)


concat = Concat


def add_n(*args, name=None, **kwargs):
    return _invoke_op("add_n", list(args), {}, name=name)


ElementWiseSum = add_n


def stack(*args, axis: int = 0, name=None, **kwargs):
    return _invoke_op("stack", list(args), {"axis": axis}, name=name)


def Custom(*args, op_type: str = "", name=None, **kwargs):
    """Raises: the CustomOp registry (``operator.py``) is not ported
    (ROADMAP.md, queue 1, item 9)."""
    from ..base import MXNetError
    raise MXNetError("sym.Custom needs operator.py, which is not ported "
                     "(ROADMAP.md, queue 1, item 9)")


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("module 'symbol' has no attribute %r" % name)
    return _make_sym_func(op)


def __dir__():
    return sorted(set(list(globals().keys()) + list_ops()))


from . import contrib  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import random  # noqa: F401,E402
