"""Captured execution: CUDA graphs, the port's counterpart of ``jax.jit``.

The JAX package compiles each hot path into an XLA executable once per
input signature and runs that executable afterwards: ``hybridize()``'s
``_CachedGraph``, ``serve.AotModel.compile_all`` (one a bucket) and
``parallel.DataParallelStep`` (the whole step).  Here the counterpart of
an executable is a captured CUDA graph.  A :class:`Captured` holds one
body, a Python function of tensors, with static input buffers.  Its first
call copies the inputs in and runs the body eagerly on a side stream:
that is the warm-up, in which cuBLAS and cuDNN make their handles and
workspaces, the kernels set their one-time attributes and NCCL makes its
communicator, all outside the capture.  Then it captures the body into a
graph on that stream (``capture_error_mode="thread_local"``, so that the
server's other threads may go on while its dispatcher captures).  Every
later call copies the inputs in, replays the graph and returns clones of
its static outputs, as an executable returns fresh arrays: an output the
caller keeps does not change under the next replay.

What the graph holds is what the capture saw: the addresses of the static
inputs, of the weights and states the body reads and writes in place, and
of the kernels' operands (the attention kernels' TMA descriptors carry
them by value).  So an owner keys its graphs on the input shapes and
dtypes, as the JAX package keys its executables, and also on the storage
of the tensors the body reads from outside (:func:`storage_key`): a
parameter whose tensor was replaced is captured again, and the telemetry
recompile detector sees it.  Values that change every call (a learning
rate, a step count) are inputs the caller writes before each replay.
Random draws come from ``generators``: each is registered with the graph,
so every replay draws new numbers and reseeding the generator restarts
them.

The hand-written kernels count their launches in Python
(``ops.fused_norm.LAUNCHES`` and the others), which does not run on a
replay: the launches that a capture recorded are taken off the counters
(they did not run) and credited again on each replay.

On the CPU there is no graph: each call copies the inputs into the static
buffers and runs the body, so that the tests exercise everything but the
capture itself.  Nothing here catches a failed capture: it raises.
"""
from __future__ import annotations

import gc
import threading
import time

import torch

__all__ = ["Captured", "capturing", "new_pool", "storage_key"]

# the kernels' launch counters: (module under mxnet_tpu_torch.ops, names)
_COUNTERS = (("fused_norm", ("LAUNCHES", "BWD_LAUNCHES")),
             ("attention", ("LAUNCHES", "BWD_LAUNCHES", "BSHD_LAUNCHES",
                            "BSHD_BWD_LAUNCHES")),
             ("layernorm", ("LAUNCHES", "BWD_LAUNCHES")))


class _Inside(threading.local):
    def __init__(self):
        self.depth = 0


_INSIDE = _Inside()


def capturing() -> bool:
    """True while this thread runs a body of a :class:`Captured` (its
    warm-up, its capture, or its run on the CPU): a hybridized block
    called there runs through, inside its caller's graph."""
    return _INSIDE.depth > 0


def _run_inside(body, inputs):
    _INSIDE.depth += 1
    try:
        return list(body(inputs))
    finally:
        _INSIDE.depth -= 1


def _counter_modules():
    from .ops import attention, fused_norm, layernorm
    return {"fused_norm": fused_norm, "attention": attention,
            "layernorm": layernorm}


def _launch_counts():
    mods = _counter_modules()
    return {(m, n): getattr(mods[m], n) for m, names in _COUNTERS
            for n in names}


def _add_launches(delta):
    mods = _counter_modules()
    for (m, n), d in delta.items():
        if d:
            mod = mods[m]
            with mod._COUNT_LOCK:
                setattr(mod, n, getattr(mod, n) + d)


def _fresh(outputs):
    return [None if o is None else o.clone() for o in outputs]


def new_pool(device):
    """A memory pool for one owner's graphs (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    with torch.cuda.device(device):
        return torch.cuda.graph_pool_handle()


def storage_key(tensors):
    """The addresses of ``tensors``: a graph that reads them is valid only
    while they stay where they were at its capture."""
    return tuple(t.data_ptr() for t in tensors)


class Captured:
    """One body, captured on the card for the shapes of its first inputs.

    ``body(inputs)`` takes the list of static input tensors (``None`` where
    an input is absent) and returns a list of output tensors; it may also
    write tensors that outlive it in place (weights, optimizer states,
    running statistics).  ``inputs`` are example inputs: the static buffers
    take their shapes, dtypes and device.  ``pool`` (:func:`new_pool`) is
    the memory pool of the graph's allocations, shared by one owner's
    graphs; ``generators`` are the ``torch.Generator`` objects the body
    draws from on the card.  ``capture_s`` is the capture's time in
    seconds, once captured."""

    def __init__(self, body, inputs, pool=None, generators=()):
        self._body = body
        self.inputs = [None if x is None else
                       torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in inputs]
        self.device = next(x.device for x in inputs if x is not None)
        self._pool = pool
        self._generators = tuple(generators)
        self._stream = None
        self._graph = None
        self._outputs = None
        self._launches = {}
        self.capture_s = None

    @property
    def graphed(self) -> bool:
        return self._graph is not None

    def _load(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(x)

    def __call__(self, inputs):
        """Copy ``inputs`` into the static buffers and run: on the card the
        warm-up and the capture on the first call, a replay after; on the
        CPU the body.  Returns fresh output tensors."""
        self._load(inputs)
        if self.device.type != "cuda":
            return _fresh(_run_inside(self._body, self.inputs))
        if self._graph is None:
            return self._warm_up_and_capture()
        self._graph.replay()
        _add_launches(self._launches)
        return _fresh(self._outputs)

    def run_eager(self, inputs):
        """The body run eagerly on the static buffers, on the current
        stream, without the graph: what a replay is held to."""
        self._load(inputs)
        return _fresh(_run_inside(self._body, self.inputs))

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = _run_inside(self._body, self.inputs)
        cur.wait_stream(side)
        fresh = _fresh(outs)
        del outs
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = _launch_counts()
        # no garbage collection inside the capture: a collected graph of an
        # earlier owner would free its memory mid-capture, which the
        # capture cannot hold (torch.cuda.graph collects just before)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                static = _run_inside(self._body, self.inputs)
        finally:
            if collecting:
                gc.enable()
        after = _launch_counts()
        # the capture recorded these launches; they run on each replay
        self._launches = {k: after[k] - before[k] for k in after}
        _add_launches({k: -v for k, v in self._launches.items()})
        self._graph, self._outputs = graph, static
        self.capture_s = time.perf_counter() - t0
        return fresh
