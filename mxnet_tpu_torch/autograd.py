"""Imperative autograd with MXNet's semantics over torch's autograd.

Counterpart of ``mxnet_tpu/autograd.py``: ``record``/``pause`` scopes with
their training flag, ``mark_variables``, ``backward``, ``grad`` and a
custom ``Function``.  There is no tape of its own: a recorded op is a torch
op run with grad mode on, and ``backward`` is ``torch.autograd.backward``.
What this module adds to torch are MXNet's rules:

* nothing outside ``record()`` builds a graph: every op of the package runs
  under :func:`op_scope`, which turns torch's grad mode on only while
  recording, and ``record``/``pause`` also set torch's grad mode for the
  code inside them (``pause()`` is a ``torch.no_grad`` scope);
* a variable (``attach_grad``/``mark_variables``) owns a gradient buffer,
  an NDArray, with ``grad_req`` ``'write'`` (each backward overwrites it),
  ``'add'`` (each backward adds to it) or ``'null'``; torch's own
  ``.grad`` of the leaf is moved into that buffer, and cleared, after every
  backward that reaches it.  The buffer stays where it is: ``'write'``
  copies into it, so a captured update that reads it (``Trainer.step``)
  finds each step's gradient at one address;
* ``backward(head_grads=None)`` seeds ones, as the JAX package does.

Both flags are thread-local, as torch's grad mode is, so a worker thread
starts in predict mode, not recording.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Optional

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "op_scope",
           "call_op", "mark_variables", "backward", "grad", "Function",
           "get_symbol"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


_KEEP = contextlib.nullcontext()


def op_scope():
    """The torch grad mode an op of the package runs in: on while
    recording, off otherwise.  Torch's mode is switched only where it
    differs (a serving forward runs in ``inference_mode``, where grad mode
    is already off, and a recorded one inside ``record``)."""
    recording = _STATE.recording
    if torch.is_grad_enabled() == recording:
        return _KEEP
    return torch.set_grad_enabled(recording)


def call_op(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in :func:`op_scope`'s grad mode, without a
    context manager where the mode already fits (every registered op of a
    forward passes here)."""
    recording = _STATE.recording
    if torch.is_grad_enabled() == recording:
        return fn(*args, **kwargs)
    with torch.set_grad_enabled(recording):
        return fn(*args, **kwargs)


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training
        self._grad_mode = None

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
            self._grad_mode = torch.set_grad_enabled(self._rec)
            self._grad_mode.__enter__()
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *a):
        if self._rec is not None:
            self._grad_mode.__exit__(*a)
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)
        return False


def record(train_mode: bool = True) -> _Scope:
    """Scope in which ops are recorded for ``backward`` (training mode on
    unless ``train_mode=False``)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope in which nothing is recorded (a ``torch.no_grad`` scope)."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


# ---------------------------------------------------------------------------
# variables and their gradient buffers
# ---------------------------------------------------------------------------

def _move_grad(var_ref, tensor):
    """Post-accumulate hook of a variable's leaf tensor: move the gradient
    torch accumulated into the variable's buffer (``'write'`` copies it in,
    ``'add'`` adds it) and clear the leaf's ``.grad``.  A gradient that
    carries a graph (``create_graph``) replaces the buffer's tensor under
    ``'write'``, so that it can be differentiated again."""
    g = tensor.grad
    tensor.grad = None
    var = var_ref()
    if var is None or g is None or var._grad_req == "null" \
            or var._grad is None:
        return
    buf = var._grad
    with torch.no_grad():
        if var._grad_req == "add":
            buf._data.add_(g)
        elif g.requires_grad or buf._data.requires_grad:
            buf._data = g if g.dtype == buf._data.dtype else g.to(
                buf._data.dtype)
        else:
            buf._data.copy_(g)
    var._fresh_grad = True


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each NDArray a variable: its tensor becomes a leaf that
    requires grad, and ``backward`` writes or adds its gradient into the
    matching NDArray of ``gradients``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, buf, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of 'write', 'add', or "
                             "'null', but got %r" % (req,))
        t = var._data
        if t.grad_fn is not None or not t.is_leaf:
            t = t.detach()
        if not t.requires_grad:
            t.requires_grad_(req != "null")
        if getattr(var, "_hooked", None) is not t:
            t.register_post_accumulate_grad_hook(
                lambda tensor, ref=weakref.ref(var): _move_grad(ref, tensor))
            var._hooked = t
        var._data = t
        var._grad = buf
        var._grad_req = req
        var._fresh_grad = False


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    tensors = []
    for h in heads:
        if not h._data.requires_grad:
            raise ValueError(
                "cannot differentiate a head that is not the output of a "
                "recorded computation (did you forget autograd.record()?)")
        tensors.append(h._data)
    if head_grads is None:
        seeds = [torch.ones_like(t) for t in tensors]
    else:
        seeds = [torch.ones_like(t) if g is None else
                 (g._data if isinstance(g, NDArray) else torch.as_tensor(g))
                 .to(device=t.device, dtype=t.dtype)
                 for t, g in zip(tensors, head_grads)]
    return tensors, seeds


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True, create_graph: bool = False):
    """Backward from ``heads`` (seeded with ones unless ``head_grads`` are
    given) into the gradient buffers of the variables they depend on."""
    tensors, seeds = _heads(heads, head_grads)
    torch.autograd.backward(tensors, seeds, retain_graph=retain_graph,
                            create_graph=create_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` as new
    NDArrays, leaving the variables' gradient buffers as they are."""
    from .ndarray.ndarray import NDArray, _wrap
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    for v in variables:
        if getattr(v, "_grad_req", None) is None or not v._data.is_leaf:
            raise ValueError("autograd.grad requires variables marked via "
                             "attach_grad/mark_variables")
    tensors, seeds = _heads(heads, head_grads)
    outs = torch.autograd.grad(
        tensors, [v._data for v in variables], seeds,
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=True)
    res = [_wrap(torch.zeros_like(v._data) if g is None else g)
           for v, g in zip(variables, outs)]
    return res[0] if single else res


class Function:
    """Custom differentiable function: subclass and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` with
    NDArray operations; ``save_for_backward`` keeps arrays for the
    backward."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _wrap
        fn = self

        class _Bridge(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *values):
                with pause():
                    out = fn.forward(*[_wrap(v) for v in values])
                outs = [out] if isinstance(out, NDArray) else list(out)
                ctx.single = isinstance(out, NDArray)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                with pause():
                    gs = fn.backward(*[_wrap(c) for c in cts])
                gs = [gs] if isinstance(gs, NDArray) else list(gs)
                return tuple(g._data for g in gs)

        with op_scope():
            outs = _Bridge.apply(*[x._data for x in inputs])
        wrapped = [_wrap(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else wrapped


def get_symbol(x):
    """Raises, as the JAX package's does: build a graph with ``sym.var``
    and a block called on it instead."""
    raise NotImplementedError(
        "get_symbol: use mxnet_tpu_torch.symbol tracing (sym.var + "
        "block(sym)) instead")
