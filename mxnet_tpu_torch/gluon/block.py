"""Gluon Block and HybridBlock as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py``.  Kept from there: name scopes
and the auto-naming counters (``resnetv10_conv2d0_weight``...),
``collect_params``, ``_collect_params_with_prefix`` (structural names such
as ``features.5.0.body.0.weight``), ``save_parameters`` and
``load_parameters`` keyed by structural names, and ``hybrid_forward(F, x,
**params)`` with ``F`` the ``mx.nd`` namespace.  Child blocks are torch
submodules (``named_modules()`` sees the tree) and forward hooks are
torch's.

``hybridize()`` turns on compiled execution, as in the JAX package, where
``_CachedGraph`` is a ``jax.jit`` cache keyed by ``(training, input shapes
and dtypes)``.  Here ``_CachedGraph`` keeps one CUDA graph per such key
(``cuda_graph.Captured``), also keyed on the storage of the block's
parameters, so that a parameter whose tensor was replaced (``reset_ctx``,
``load_parameters`` onto a new context) is captured again instead of
read at its old address; ``set_data`` writes in place and needs nothing.
``summary`` prints each layer's output shape and parameter count;
``export`` writes the parameters.
The forward and its writes of auxiliary state (BatchNorm's running
statistics) are captured whenever no gradient is recorded.  These calls
run eagerly, as in the JAX package: a call with keyword arguments, a first
call that completes deferred shapes, and a child called inside its
parent's graph (or any captured body), which runs through.  Under
``autograd.record()`` a hybridized block runs eagerly too (a forward and
backward pair of graphs waits: ``ROADMAP.md``, queue 1).
``hybridize(False)`` and ``cast`` drop the graphs.  Called on a Symbol, a
``HybridBlock`` builds a graph: ``hybrid_forward(mx.sym, x, ...)`` with
each parameter as ``Parameter.var()``.  ``SymbolBlock`` runs a Symbol
graph as a block (``SymbolBlock.imports`` reads ``model.save_checkpoint``'s
files); its parameters are named as the graph's arguments, as MXNet's.
"""
from __future__ import annotations

import re
import threading

import numpy as onp
import torch

from .. import autograd, telemetry
from .. import random as _random
from ..context import cpu
from ..cuda_graph import Captured, capturing, new_pool, storage_key
from ..ndarray.ndarray import NDArray, _wrap
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _NameCounter(threading.local):
    def __init__(self):
        self.counts = {}


_GLOBAL_NAMES = _NameCounter()


class _BlockScope:
    """Name-scope manager assigning unique prefixes."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                cnt = _GLOBAL_NAMES.counts.get(hint, 0)
                _GLOBAL_NAMES.counts[hint] = cnt + 1
                prefix = "%s%d_" % (hint, cnt)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            cnt = current._counter.get(hint, 0)
            current._counter[hint] = cnt + 1
            prefix = "%s%d_" % (hint, cnt)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  (%s): %s" % (key, _indent(repr(block), 2))
                           for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

    def __setattr__(self, name, value):
        """Assigning a Block registers a child (a torch submodule);
        assigning a Parameter registers it with this block."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise TypeError("Changing attribute type for %s from %s to %s "
                                "is not allowed." % (name, type(existing),
                                                     type(value)))
        if isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not value:
                raise AssertionError("Overriding Parameter attribute %s is "
                                     "not allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def _children(self):
        """Child blocks by name, in registration order (torch's own
        submodule table)."""
        return {k: v for k, v in self._modules.items() if v is not None}

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        """This block's own parameters, without its descendants'."""
        return self._params

    def collect_params(self, select=None):
        """This block's and all descendants' parameters, optionally
        filtered by the regular expression ``select``."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``, e.g. ``features.0.weight``."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)`` unless a ``with mx.cpu():`` scope is open)."""
        from .. import initializer as _init
        init = init if init is not None else _init.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Turn compiled execution on (or off) for the hybrid blocks of
        this tree."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast this block's and its descendants' parameters to ``dtype``
        (``net.cast("bfloat16")``)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def save_parameters(self, filename):
        """Save with structural names, in the JAX package's npz format."""
        from ..ndarray.utils import save as nd_save
        params = self._collect_params_with_prefix()
        nd_save(filename, {key: val.data() for key, val in params.items()
                           if val._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a file written by ``save_parameters`` (of either package).
        Arrays are read on the host and copied onto each parameter's own
        context (``ctx`` for parameters not yet allocated)."""
        from ..ndarray.utils import load as nd_load
        loaded = nd_load(filename, ctx=cpu())
        if not isinstance(loaded, dict):
            raise ValueError("load_parameters needs a name->NDArray dict "
                             "file; %r contains an unnamed array list"
                             % (filename,))
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError("Parameter '%s' is missing in file "
                                         "'%s'" % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in this Block" % (name, filename))
                continue
            params[name]._load_init(value, ctx)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print each layer's output
        shape and parameter count, as the JAX package's ``summary``."""
        summary = {}
        handles = []

        def _register(block, prefix):
            def hook(blk, inp, out):
                name = prefix or blk.__class__.__name__
                out0 = out[0] if isinstance(out, (list, tuple)) else out
                n_params = sum(int(onp.prod(p.shape))
                               for p in blk._reg_params.values()
                               if p._data is not None)
                summary[name + " (" + blk.__class__.__name__ + ")"] = (
                    tuple(out0.shape), n_params)
            handles.append(block.register_forward_hook(hook))
            for cname, child in block._children.items():
                _register(child, (prefix + "." if prefix else "") + cname)

        _register(self, "")
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        print("-" * 70)
        print("%-40s %-20s %10s" % ("Layer (type)", "Output Shape", "Param #"))
        print("=" * 70)
        total = 0
        for name, (shape, n) in summary.items():
            print("%-40s %-20s %10d" % (name[:40], str(shape), n))
            total += n
        print("=" * 70)
        print("Total params: %d" % total)


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    return lines[0] + "\n" + "\n".join(" " * num_spaces + line
                                       for line in lines[1:])


def _flatten_args(args):
    """Flatten (possibly nested lists of) NDArrays into a list and a
    template."""
    arrays = []

    def conv(a):
        if isinstance(a, NDArray):
            arrays.append(a)
            return ("__arr__", len(arrays) - 1)
        if isinstance(a, (list, tuple)):
            return ("__list__", [conv(x) for x in a], isinstance(a, tuple))
        return ("__static__", a)

    template = [conv(a) for a in args]
    return arrays, template


def _rebuild_args(template, arrays):
    def conv(t):
        if t[0] == "__arr__":
            return arrays[t[1]]
        if t[0] == "__list__":
            items = [conv(x) for x in t[1]]
            return tuple(items) if t[2] else items
        return t[1]

    return [conv(t) for t in template]


class _CachedGraph:
    """The CachedOp counterpart: one captured forward of a block per
    ``(training, input shapes and dtypes)``, from one memory pool.  The
    parameter list is fixed for the life of the cache (``hybridize()`` and
    ``cast`` make a new one), as in the JAX package."""

    def __init__(self, block):
        self._block = block
        self._cache = {}
        self._params = [p for _, p in sorted(block.collect_params().items())
                        if p._data is not None]
        self._pool = None

    def clear(self):
        self._cache.clear()

    def __call__(self, args):
        arrays, template = _flatten_args(args)
        training = autograd.is_training()
        key = (training, tuple((tuple(a.shape), str(a.dtype))
                               for a in arrays))
        storage = storage_key([p._data._data for p in self._params])
        hit = self._cache.get(key)
        if hit is None or hit[1] != storage:
            telemetry.record_compile(
                "CachedOp_%s" % self._block.name,
                {"training": training,
                 "inputs": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                            for a in arrays]})
            hit = self._cache[key] = (self._build(template, training,
                                                  arrays), storage)
        graph, meta = hit[0]
        outs = [_wrap(o) for o in graph([a._data for a in arrays])]
        return outs if meta["seq"] else outs[0]

    def _build(self, template, training, arrays):
        block = self._block
        meta = {"seq": None}

        def body(inputs):
            args = _rebuild_args(template, [_wrap(v) for v in inputs])
            with autograd.pause(train_mode=training):
                out = block.forward(*args)
            meta["seq"] = isinstance(out, (list, tuple))
            return [o._data for o in (out if meta["seq"] else [out])]
        device = arrays[0]._data.device
        if self._pool is None:
            self._pool = new_pool(device)
        # the device's generator is registered in either mode: dropout
        # draws while training, and a block may draw (F.random.normal) in
        # either; each replay draws new numbers, as each call of the JAX
        # package's _CachedGraph takes a fresh key
        gens = (_random.generator(device),) if device.type == "cuda" else ()
        return Captured(body, [a._data for a in arrays], pool=self._pool,
                        generators=gens), meta


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = None

    def hybridize(self, active=True, **kwargs):
        """Compiled execution on or off (``static_alloc`` and
        ``static_shape`` are accepted: a graph's memory is static)."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def _clear_cached_op(self):
        if self._cached_graph is not None:
            self._cached_graph.clear()
        self._cached_graph = None

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _deferred_params(self):
        return [p for p in self.collect_params().values() if p._data is None]

    def __call__(self, *args, **kwargs):
        if not self._active or kwargs or capturing() \
                or autograd.is_recording() or self._deferred_params():
            # eager: keyword arguments are not in the key, a parent's graph
            # runs its children through, a recorded forward waits for a
            # forward/backward pair, and a first call completes deferred
            # shapes
            return super().__call__(*args, **kwargs)
        arrays, _ = _flatten_args(args)
        if not arrays:
            return super().__call__(*args, **kwargs)
        if self._cached_graph is None:
            self._cached_graph = _CachedGraph(self)
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self._cached_graph(args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from the input shapes; layers
        with deferred parameters override this."""

    def forward(self, x, *args):
        """Fetch this block's parameters (finishing deferred ones from
        ``x``) and call ``hybrid_forward`` with ``F = mx.nd``; on a Symbol
        ``x``, call it with ``F = mx.sym`` and each parameter's
        ``var()``."""
        from .. import ndarray as nd
        from .. import symbol as sym_mod
        if isinstance(x, sym_mod.Symbol):
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(sym_mod, x, *args, **params)
        params = {}
        for name, p in self._reg_params.items():
            try:
                params[name] = p.data()
            except DeferredInitializationError:
                self.infer_shape(x, *args)
                params[name] = p.data()
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write the parameters to ``<path>-<epoch:04d>.params`` (as the
        JAX package's ``export`` does: parameters only, no graph) and
        return the file name."""
        fname = "%s-%04d.params" % (path, epoch)
        self.save_parameters(fname)
        return fname


class SymbolBlock(HybridBlock):
    """A block that runs the Symbol graph ``outputs`` on the arrays of
    ``inputs`` (variables of the graph); every other argument and
    auxiliary state of the graph is a parameter of the block, named as in
    the graph (the block's prefix is empty), with its shape deferred to
    the first call."""

    def __init__(self, outputs, inputs, params=None):
        from ..symbol import Group, Symbol
        super().__init__(prefix="", params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 else Group(outputs)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._sym_outputs = outputs
        self._sym_inputs = list(inputs)
        input_names = {i.name for i in self._sym_inputs}
        for name in outputs.list_arguments():
            if name not in input_names:
                self._reg_params[name] = self.params.get(
                    name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self._reg_params[name] = self.params.get(
                name, allow_deferred_init=True, grad_req="null")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of the graph in ``symbol_file`` whose inputs are
        ``input_names``, its parameters read from ``param_file`` (the
        ``arg:``/``aux:`` names of ``model.save_checkpoint``, or plain
        names) onto ``ctx`` (default: the current context)."""
        from .. import symbol as sym_mod
        from ..ndarray.utils import load as nd_load
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v
                      for k, v in nd_load(param_file, ctx=cpu()).items()}
            params = ret.collect_params()
            missing = sorted(set(params.keys()) - set(loaded))
            extra = sorted(set(loaded) - set(params.keys()))
            if missing or extra:
                raise AssertionError(
                    "SymbolBlock.imports: %s misses parameters %s and has "
                    "parameters %s the graph does not take"
                    % (param_file, missing, extra))
            for name, value in loaded.items():
                params[name]._load_init(value, ctx)
        return ret

    def infer_shape(self, *args):
        arg_shapes, _, aux_shapes = self._sym_outputs.infer_shape(
            **{i.name: a.shape for i, a in zip(self._sym_inputs, args)})
        shapes = dict(zip(self._sym_outputs.list_arguments(), arg_shapes))
        shapes.update(zip(self._sym_outputs.list_auxiliary_states(),
                          aux_shapes))
        for name, p in self._reg_params.items():
            if p._data is None:
                p._finish_deferred_init(shapes[name])

    def forward(self, *args):
        if any(p._data is None for p in self._reg_params.values()):
            self.infer_shape(*args)
        arg_dict = {i.name: a for i, a in zip(self._sym_inputs, args)}
        for name, p in self._reg_params.items():
            arg_dict[name] = p.data()
        return self._sym_outputs.eval_imperative(arg_dict)
