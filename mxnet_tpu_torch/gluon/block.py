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
statistics) are captured whenever no gradient is recorded.  Under
``autograd.record()`` a call is a forward and backward pair of graphs
(``cuda_graph.CapturedPair``), keyed also on the recording flag and on
which inputs and parameters need a gradient: the call returns the outputs
of a ``torch.autograd.Function`` whose forward replays the forward graph
and whose backward replays the backward graph, returning the gradients of
the inputs and of the parameters, which the parameters' hooks then write
or add into their buffers as after an eager backward (``grad_req``
``'write'``, ``'add'`` and ``'null'`` hold).  The running statistics are
written in the forward graph, once a call, as the JAX package writes back
its ``meta["mutated"]``.  Three cases:

* the same key called twice before a backward (a siamese net, several
  micro-batches in one ``record()``): a replay would overwrite the
  activations the first call saved, so a pair is busy from its forward
  until its backward runs or its graph dies, and a call that finds every
  pair of its key busy builds another (one build more, reported), with a
  memory pool of its own, so that its backwards may run in either order;
* ``autograd.grad(..., create_graph=True)``: a captured backward is not
  differentiable, so under ``create_graph`` (or after its forward was
  overwritten) the Function's backward runs the body again eagerly on the
  call's own inputs, with the forward's random state and the running
  statistics left alone, and differentiates it: the same values, and a
  graph through them;
* inputs that need a gradient (``attach_grad``, or the outputs of earlier
  recorded operations): their gradients come out of the backward graph
  too.

These calls run eagerly, as in the JAX package: a call with keyword
arguments, a first call that completes deferred shapes, and a child called
inside its parent's graph (or any captured body), which runs through.
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
from ..cuda_graph import (Captured, CapturedPair, _run_inside, capturing,
                          new_pool, storage_key)
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
    ``(training, input shapes and dtypes)``, from one memory pool, and
    under ``autograd.record()`` captured forward and backward pairs, each
    with a pool of its own, per ``(training, which inputs and parameters
    need a gradient, input shapes and dtypes)``.  The parameter list is
    fixed for the life of the cache (``hybridize()`` and ``cast`` make a
    new one), as in the JAX package."""

    def __init__(self, block):
        self._block = block
        self._cache = {}
        self._params = [p for _, p in sorted(block.collect_params().items())
                        if p._data is not None]
        self._pool = None

    def clear(self):
        self._cache.clear()

    def _report(self, key_doc):
        telemetry.record_compile("CachedOp_%s" % self._block.name, key_doc)

    def __call__(self, args):
        arrays, template = _flatten_args(args)
        training = autograd.is_training()
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in arrays)
        doc = {"training": training,
               "inputs": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                          for a in arrays]}
        tensors = [p._data._data for p in self._params]
        storage = storage_key(tensors)
        if autograd.is_recording():
            needs = tuple(a._data.requires_grad for a in arrays)
            diff = tuple(t.requires_grad for t in tensors)
            if any(needs) or any(diff):
                return self._recorded((training, True, needs, diff, sig),
                                      storage, template, arrays, doc)
        key = (training, sig)
        hit = self._cache.get(key)
        if hit is None or hit[1] != storage:
            self._report(doc)
            hit = self._cache[key] = (self._build(template, training,
                                                  arrays), storage)
        graph, meta = hit[0]
        outs = [_wrap(o) for o in graph([a._data for a in arrays])]
        return outs if meta["seq"] else outs[0]

    def _generators(self, device):
        # the device's generator is registered in either mode: dropout
        # draws while training, and a block may draw (F.random.normal) in
        # either; each replay draws new numbers, as each call of the JAX
        # package's _CachedGraph takes a fresh key
        return (_random.generator(device),) if device.type == "cuda" else ()

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
        return Captured(body, [a._data for a in arrays], pool=self._pool,
                        generators=self._generators(device)), meta

    def _recorded(self, key, storage, template, arrays, doc):
        hit = self._cache.get(key)
        if hit is None or hit[1] != storage:
            hit = self._cache[key] = (_Recorded(self, template, key[0],
                                                key[2], key[3]), storage)
        rec = hit[0]
        pair = rec.free_pair(arrays, doc)
        outs = _ReplayCall.apply(rec, pair, *[a._data for a in arrays],
                                 *rec.weights())
        outs = [_wrap(o) for o in outs]
        return outs if rec.meta["seq"] else outs[0]


class _Recorded:
    """The recorded calls of one key: its pairs (one a call in flight),
    the parameters the gradient reaches and the body they share."""

    def __init__(self, cache, template, training, needs, diff):
        self._cache = cache
        self._template = template
        self.training = training
        self.needs = needs
        self._diff = [p for p, d in zip(cache._params, diff) if d]
        self._aux = [p for p, d in zip(cache._params, diff) if not d]
        self.meta = {"seq": None}
        self.pairs = []

    def weights(self):
        return [p._data._data for p in self._diff]

    def _forward(self, inputs, weights):
        """The block's forward on ``inputs``, recorded, with each
        parameter the gradient reaches read as ``weights``."""
        holders = [p._data for p in self._diff]
        saved = [h._data for h in holders]
        for h, w in zip(holders, weights):
            h._data = w
        try:
            args = _rebuild_args(self._template, [_wrap(v) for v in inputs])
            with autograd.record(train_mode=self.training):
                out = self._cache._block.forward(*args)
        finally:
            for h, t in zip(holders, saved):
                h._data = t
        self.meta["seq"] = isinstance(out, (list, tuple))
        return [o._data for o in (out if self.meta["seq"] else [out])]

    def free_pair(self, arrays, doc):
        """A pair of this key that no call in flight holds, built (and
        reported to the recompile detector) when there is none."""
        for pair in self.pairs:
            if not pair.busy:
                return pair
        self._cache._report(dict(doc, recording=True,
                                 needs_grad=list(self.needs),
                                 pair=len(self.pairs)))
        device = arrays[0]._data.device
        pair = CapturedPair(self._forward, [a._data for a in arrays],
                            self.needs, self.weights(),
                            generators=self._cache._generators(device),
                            state=[p._data._data for p in self._aux])
        self.pairs.append(pair)
        return pair

    def rerun(self, saved, cots, rng):
        """The eager backward: the body run again on the call's own
        inputs and parameters (``saved``) from the forward's random state
        ``rng``, the running statistics it writes set aside, and
        differentiated from ``cots``; a graph through the result under
        ``create_graph``."""
        n = len(self.needs)
        inputs, weights = list(saved[:n]), list(saved[n:])
        gen = _random.generator(inputs[0].device)
        now = gen.get_state()
        holders = [p._data for p in self._aux]
        kept = [h._data for h in holders]
        gen.set_state(rng)
        for h in holders:
            h._data = h._data.detach().clone()
        try:
            with torch.enable_grad():
                outs = _run_inside(self._forward, inputs, weights)
        finally:
            for h, t in zip(holders, kept):
                h._data = t
            gen.set_state(now)
        wrt = [x for x, f in zip(inputs, self.needs) if f] + weights
        pairs = [(o, torch.zeros_like(o) if c is None else c)
                 for o, c in zip(outs, cots) if o.requires_grad]
        grads = [None] * len(wrt)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [c for _, c in pairs],
                create_graph=torch.is_grad_enabled(), allow_unused=True)
        it = iter(grads)
        return [next(it) if f else None for f in self.needs] + \
            [next(it) for _ in weights]


class _Release:
    """Frees its pair for other calls when the graph of its call dies
    without a backward."""

    def __init__(self, pair, gen):
        self._pair, self._gen = pair, gen

    def __del__(self):
        self._pair.release(self._gen)


class _ReplayCall(torch.autograd.Function):
    """A recorded call of a hybridized block: the forward replays the
    pair's forward graph, the backward its backward graph (or, under
    ``create_graph`` or once a later forward overwrote this one's
    activations, :meth:`_Recorded.rerun`)."""

    @staticmethod
    def forward(ctx, rec, pair, *tensors):
        n = len(rec.needs)
        ctx.rng = _random.generator(pair.device).get_state()
        outs, gen = pair.forward(tensors[:n])
        ctx.rec, ctx.pair, ctx.gen = rec, pair, gen
        ctx.release = _Release(pair, gen)
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        if torch.is_grad_enabled() or ctx.gen != ctx.pair.gen:
            grads = ctx.rec.rerun(ctx.saved_tensors, cots, ctx.rng)
        else:
            grads = ctx.pair.backward(ctx.gen, cots)
        return (None, None) + tuple(grads)


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
                or self._deferred_params():
            # eager: keyword arguments are not in the key, a parent's graph
            # runs its children through, and a first call completes
            # deferred shapes
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
