"""Automatic symbol naming, the port's copy of ``mxnet_tpu/name.py``.

``NameManager`` turns a hint into ``hint0, hint1, ...``; ``Prefix``
prepends a fixed prefix.  Managers nest with ``with`` and are
thread-local, so the same construction names its nodes as the JAX
package does (``fullyconnected0``, ``fc1_weight``...).
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_current = threading.local()


class NameManager:
    """Scoped automatic namer: a given name passes through, a missing one
    becomes ``'%s%d' % (hint, counter[hint]++)``."""

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        cnt = self._counter.get(hint, 0)
        self._counter[hint] = cnt + 1
        return "%s%d" % (hint, cnt)

    def __enter__(self):
        if not hasattr(_current, "value"):
            _current.value = NameManager()
        self._old_manager = _current.value
        _current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager is not None
        _current.value = self._old_manager

    @property
    def current(self):
        return current()


class Prefix(NameManager):
    """A name manager that puts ``prefix`` before every name it makes:
    ``with mx.name.Prefix('mynet_'): ...``."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current() -> NameManager:
    """The active manager of this thread (the default one made lazily)."""
    if not hasattr(_current, "value"):
        _current.value = NameManager()
    return _current.value
