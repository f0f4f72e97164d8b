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

A :class:`CapturedPair` is the training counterpart: a body's forward and
the gradient of its outputs as two graphs from a pool of their own, in the
order of ``torch.cuda.make_graphed_callables`` (warm-up on a side stream,
capture the forward, capture the backward on static output gradients).  It
is
what a hybridized block called under ``autograd.record()`` and an
``Executor`` trained through ``forward``/``backward`` replay, as the JAX
package runs its jitted forward and that function's ``jax.vjp``.

On the CPU there is no graph: each call copies the inputs into the static
buffers and runs the body (a pair: with autograd, keeping the graph for
its backward), so that the tests exercise everything but the capture
itself.  :func:`disabled` does the same on the card, as ``jax.disable_jit``
does for the JAX package: the eager twin that a graphed run is held to.
Nothing here catches a failed capture: it raises.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

__all__ = ["Captured", "CapturedPair", "capturing", "disabled", "enabled",
           "new_pool", "storage_key"]

# the kernels' launch counters: (module under mxnet_tpu_torch.ops, names)
_COUNTERS = (("fused_norm", ("LAUNCHES", "BWD_LAUNCHES")),
             ("attention", ("LAUNCHES", "BWD_LAUNCHES", "BSHD_LAUNCHES",
                            "BSHD_BWD_LAUNCHES")),
             ("layernorm", ("LAUNCHES", "BWD_LAUNCHES")))


class _Inside(threading.local):
    def __init__(self):
        self.depth = 0
        self.off = 0


_INSIDE = _Inside()


def capturing() -> bool:
    """True while this thread runs a body of a :class:`Captured` (its
    warm-up, its capture, or its run on the CPU): a hybridized block
    called there runs through, inside its caller's graph."""
    return _INSIDE.depth > 0


def enabled() -> bool:
    """False inside :func:`disabled` on this thread."""
    return _INSIDE.off == 0


@contextlib.contextmanager
def disabled():
    """Within the scope, on this thread, every :class:`Captured` and
    :class:`CapturedPair` runs its body eagerly, as on the CPU, and
    ``Trainer.step`` updates through the optimizer's eager fused update:
    the port's ``jax.disable_jit()``, for holding a graphed run to the same
    code run eagerly.  Graphs built before stay and serve calls after."""
    _INSIDE.off += 1
    try:
        yield
    finally:
        _INSIDE.off -= 1


def _run_inside(body, *args):
    _INSIDE.depth += 1
    try:
        return list(body(*args))
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
    return [None if o is None else o.detach().clone() for o in outputs]


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
    draws from on the card; ``device`` is the body's device where no input
    gives it.  ``capture_s`` is the capture's time in seconds, once
    captured."""

    def __init__(self, body, inputs, pool=None, generators=(), device=None):
        self._body = body
        self.inputs = [None if x is None else
                       torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in inputs]
        self.device = torch.device(device) if device is not None else \
            next(x.device for x in inputs if x is not None)
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
        if self.device.type != "cuda" or not enabled():
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


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


class CapturedPair:
    """One body's forward and the gradient of its outputs, captured on the
    card as two graphs from a memory pool that no other graph shares.

    ``body(inputs, weights)`` returns a list of output tensors; it may also
    write tensors that outlive it in place.  ``inputs`` are example inputs
    (``None`` where absent): each call copies its arguments into static
    buffers of their shapes, and ``needs_grad`` says which of them are
    differentiated.  ``weights`` are tensors the body reads in place and is
    differentiated against (a block's parameters, an Executor's bound
    arguments): the body gets fresh leaves on their storage, so the
    gradient nodes of the capture are its own, whatever graph a caller
    keeps around the tensors themselves.  ``state`` are tensors the body
    writes in place (running statistics): the warm-up's writes to them are
    undone, so that each call writes them once.  ``generators`` are
    :class:`Captured`'s.

    The pool is the pair's own because what its forward saves for its
    backward lives from one replay to the next: graphs that share a pool
    may reuse each other's freed temporaries, which is safe only when they
    replay in the order of their capture.  A second pair of one key is
    captured after the first one's backward, in whose freed temporaries its
    forward could save its activations; two calls whose backwards run
    apart replay forward 1, forward 2, backward 1, backward 2, and
    backward 1 would overwrite what forward 2 saved.

    Built on the card at the first call (:meth:`forward`), as
    ``torch.cuda.make_graphed_callables`` builds its pair: the body and its
    backward run eagerly on a side stream (the warm-up, its writes to
    ``state`` and its random draws undone), then the forward is captured
    with autograd recording, so its saved activations land in the pool,
    then ``torch.autograd.grad`` of the outputs that carry a gradient with
    respect to the differentiated inputs and the weights, on static output
    gradients.  Each graph registers ``generators``: a replay of the
    forward draws new numbers, and the backward reads the masks its
    forward saved.  The autograd graph of the capture is kept, so the saved
    activations stay allocated and no later capture from the pool takes
    their memory.  Each replay credits the hand kernels' launches that its
    graph recorded.

    A replay of the forward overwrites what the previous one saved, so
    :meth:`forward` returns a generation and :meth:`backward` takes it,
    raising if another forward ran since (an owner checks ``gen`` first).
    ``busy`` is set from a forward until its backward or :meth:`release`:
    an owner with two forwards in flight takes a second pair.

    On the CPU, and inside :func:`disabled`, there is no graph:
    :meth:`forward` runs the body with autograd on the static buffers and
    keeps that graph, which :meth:`backward` differentiates."""

    def __init__(self, body, inputs, needs_grad, weights, generators=(),
                 state=()):
        self._body = body
        self.inputs = [None if x is None else
                       torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in inputs]
        self._needs = [bool(f) and b is not None
                       for f, b in zip(needs_grad, self.inputs)]
        for b, f in zip(self.inputs, self._needs):
            if f:
                b.requires_grad_()
        self._weights = list(weights)
        self.device = next(t.device for t in list(inputs) + self._weights
                           if t is not None)
        self._generators = tuple(generators)
        self._state = list(state)
        self.gen = 0
        self.busy = False
        self._graphs = None
        self._static = None      # (outputs, leaves) of the capture
        self._live = None        # (outputs, leaves) of the last eager forward
        self._eager = True
        self._grad_outs = None
        self._grads = None
        self._launches = ({}, {})
        self.warmup_s = None
        self.capture_s = None

    @property
    def graphed(self) -> bool:
        return self._graphs is not None

    def _leaves(self):
        return [w.detach().requires_grad_() for w in self._weights]

    def _forward_with_grad(self, leaves):
        with torch.enable_grad():
            return _run_inside(self._body, self.inputs, leaves)

    def _wrt(self, leaves):
        return [b for b, f in zip(self.inputs, self._needs) if f] + leaves

    def _spread(self, grads):
        """``grads`` of the differentiated inputs and the weights, laid out
        as one entry an input (``None`` where not differentiated) followed
        by one a weight."""
        it = iter(grads)
        out = [next(it) if f else None for f in self._needs]
        return out + [next(it) for _ in self._weights]

    def forward(self, inputs):
        """Copy ``inputs`` into the static buffers and run the forward (a
        replay on the card, built at the first call).  Returns fresh output
        tensors, without a graph, and the generation that
        :meth:`backward` takes."""
        with torch.no_grad():
            for buf, x in zip(self.inputs, inputs):
                if buf is not None:
                    buf.copy_(x)
        self._eager = self.device.type != "cuda" or not enabled()
        if self._eager:
            leaves = self._leaves()
            outs = self._forward_with_grad(leaves)
            self._live = (outs, leaves)
        else:
            if self._graphs is None:
                self._build()
            self._graphs[0].replay()
            _add_launches(self._launches[0])
            outs = self._static[0]
        self.gen += 1
        self.busy = True
        return _fresh(outs), self.gen

    def backward(self, gen, grad_outputs):
        """The gradients of forward ``gen`` from ``grad_outputs`` (one a
        forward output; those of outputs that carry no gradient are not
        read): a list with one entry an input (``None`` where not
        differentiated) and one a weight, each a new tensor or ``None``
        where the outputs do not depend on it."""
        if gen != self.gen:
            raise RuntimeError("forward %s was overwritten by forward %d"
                               % (gen, self.gen))
        self.busy = False
        outs, leaves = self._live if self._eager else self._static
        pairs = [(o, torch.zeros_like(o) if g is None else g)
                 for o, g in zip(outs, grad_outputs)
                 if o is not None and o.requires_grad]
        if self._eager:
            grads = [None] * len(self._wrt(leaves))
            if pairs:
                grads = torch.autograd.grad(
                    [o for o, _ in pairs], self._wrt(leaves),
                    [g.to(o.dtype) for o, g in pairs], retain_graph=True,
                    allow_unused=True)
            return self._spread([None if g is None else g.detach()
                                 for g in grads])
        with torch.no_grad():
            for buf, (_, g) in zip(self._grad_outs, pairs):
                buf.copy_(g)
        self._graphs[1].replay()
        _add_launches(self._launches[1])
        return self._spread([None if g is None else g.clone()
                             for g in self._grads])

    def release(self, gen):
        """Forward ``gen`` needs no backward any more (its graph died)."""
        if gen == self.gen:
            self.busy = False

    def _build(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        rng = [g.get_state() for g in self._generators]
        with torch.cuda.stream(side):
            with torch.no_grad():
                kept = [s.clone() for s in self._state]
            leaves = self._leaves()
            outs = self._forward_with_grad(leaves)
            carry = [o for o in outs if o is not None and o.requires_grad]
            if carry:
                torch.autograd.grad(carry, self._wrt(leaves),
                                    [torch.zeros_like(o) for o in carry],
                                    allow_unused=True)
            with torch.no_grad():
                for s, k in zip(self._state, kept):
                    s.copy_(k)
        cur.wait_stream(side)
        del outs, carry, leaves, kept
        for g, st in zip(self._generators, rng):
            g.set_state(st)
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = new_pool(self.device)
        for gen in self._generators:
            fwd.register_generator_state(gen)
            bwd.register_generator_state(gen)
        before = _launch_counts()
        # no garbage collection inside a capture (see Captured)
        collecting = gc.isenabled()
        gc.disable()
        try:
            leaves = self._leaves()
            with torch.cuda.graph(fwd, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                outs = self._forward_with_grad(leaves)
            mid = _launch_counts()
            carry = [o for o in outs if o is not None and o.requires_grad]
            grad_outs = [torch.empty_like(o) for o in carry]
            grads = [None] * len(self._wrt(leaves))
            with torch.cuda.graph(bwd, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                if carry:
                    # the graph is retained: its saved activations stay
                    # allocated, out of reach of later captures
                    grads = torch.autograd.grad(
                        carry, self._wrt(leaves), grad_outs,
                        retain_graph=True, allow_unused=True)
        finally:
            if collecting:
                gc.enable()
        after = _launch_counts()
        # the captures recorded these launches; they run on each replay
        self._launches = (_delta(before, mid), _delta(mid, after))
        _add_launches({k: -v for k, v in _delta(before, after).items()})
        self._graphs = (fwd, bwd)
        self._static = (outs, leaves)
        self._grad_outs, self._grads = grad_outs, list(grads)
        self.capture_s = time.perf_counter() - t0
