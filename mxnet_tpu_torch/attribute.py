"""Symbol attribute scoping, the port's copy of ``mxnet_tpu/attribute.py``.

``AttrScope`` gives a set of string attributes to every symbol made inside
its ``with`` block (``ctx_group``, ``__lr_mult__``, user metadata).  Scopes
nest (the inner value wins), are thread-local, and merge under a call's
own ``attr=`` dict.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_current = threading.local()


class AttrScope:
    """Attribute manager for scoping (``with mx.AttrScope(x='y'): ...``)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be string")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """This scope's attributes merged under ``attr`` (whose values
        win), as a new dict."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        if not hasattr(_current, "value"):
            _current.value = AttrScope()
        self._old_scope = _current.value
        attr = _current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        _current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope is not None
        _current.value = self._old_scope


def current() -> AttrScope:
    """The active scope of this thread (the default one made lazily)."""
    if not hasattr(_current, "value"):
        _current.value = AttrScope()
    return _current.value
