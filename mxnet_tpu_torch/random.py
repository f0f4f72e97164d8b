"""Random number state: MXNet's stateful seed over ``torch.Generator``s.

Counterpart of ``mxnet_tpu/random.py``, which hides a JAX PRNG key
stream behind ``mx.random.seed``.  Here the state is one
``torch.Generator`` per device, created on first use and seeded from the
last ``seed()`` (0 before any).  The two packages draw different numbers
from the same seed; tests that compare them carry weights across.
``generator_scope`` lends one generator to the ops of a scope (the
data-parallel step's dropout stream), ``draw_seed`` takes a seed for it
from the host generator, and ``seed_epoch`` counts the ``seed()`` calls,
so that an owner of its own generator reseeds it after a new
``mx.random.seed``, as the JAX package's step draws a new key then.  The
distribution draws (``mx.random.uniform``, ``normal``...) are
``mx.nd.random``'s.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "generator_scope", "draw_seed",
           "seed_epoch"]


class _RngState:
    def __init__(self):
        self.lock = threading.Lock()
        self.seed = 0
        self.epoch = 0
        self.generators = {}       # torch.device -> torch.Generator


_STATE = _RngState()


class _Lent(threading.local):
    def __init__(self):
        self.generator = None


_LENT = _Lent()


def seed(seed_state: int, ctx="all") -> None:
    """Seed every device's generator (``ctx="all"``) or one context's."""
    with _STATE.lock:
        _STATE.epoch += 1
        if ctx == "all":
            _STATE.seed = int(seed_state)
            for g in _STATE.generators.values():
                g.manual_seed(_STATE.seed)
            return
    generator(ctx.torch_device).manual_seed(int(seed_state))


def _indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current CUDA device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device`` or a name)."""
    device = _indexed(device)
    lent = _LENT.generator
    if lent is not None and _indexed(lent.device) == device:
        return lent
    with _STATE.lock:
        g = _STATE.generators.get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(_STATE.seed)
            _STATE.generators[device] = g
        return g


@contextlib.contextmanager
def generator_scope(gen: torch.Generator):
    """Within the scope, ``generator`` of ``gen``'s device returns ``gen``
    on this thread."""
    prev, _LENT.generator = _LENT.generator, gen
    try:
        yield gen
    finally:
        _LENT.generator = prev


def draw_seed() -> int:
    """A seed drawn from the host generator (no device is touched)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator("cpu")))


def seed_epoch() -> int:
    """The number of ``seed()`` calls so far."""
    return _STATE.epoch


def __getattr__(name):
    # the distribution draws are nd.random's, as in the JAX package
    from .ndarray import random as _ndrandom
    try:
        return getattr(_ndrandom, name)
    except AttributeError:
        raise AttributeError("module 'random' has no attribute %r" % name)
