"""Device context over ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  ``mx.gpu(i)`` is ``cuda:i`` and
``mx.cpu()`` is the host.  Unlike the JAX package, whose default context
is the CPU, the port's default context is ``gpu(0)``: the card is where
it runs.  A context resolves to a device only through
:attr:`Context.torch_device`, which raises when a GPU context is asked
for on a machine without CUDA, so nothing falls back to the CPU unless
the caller asked for ``mx.cpu()``.  ``cpu_pinned()`` is the host too:
an array there lives in page-locked memory, which the card copies from
without staging.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "gpu_memory_info"]


class Context:
    """A device context ``(device_type, device_id)``, usable as a ``with``
    scope that sets the default context on this thread."""

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context.  Raises for a GPU context
        when CUDA is absent or the id is out of range."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device and none is available; "
                "pass ctx=mx.cpu() to run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s out of range: %d CUDA device(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_device(device: torch.device) -> "Context":
        if device.type == "cpu":
            return Context("cpu", 0)
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        raise MXNetError("no context for device %s" % device)

    def __enter__(self):
        self._old_ctx = getattr(Context._default, "value", None)
        Context._default.value = self
        return self

    def __exit__(self, *args):
        Context._default.value = self._old_ctx
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """The CUDA device ``cuda:<device_id>``."""
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA devices visible."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of the card ``device_id``."""
    return torch.cuda.mem_get_info(gpu(device_id).torch_device)


def current_context() -> Context:
    """The innermost ``with Context`` scope on this thread, else ``gpu(0)``."""
    ctx = getattr(Context._default, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)
