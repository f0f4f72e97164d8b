"""``mx.sym.contrib``: the registry's ``_contrib_*`` ops (or their bare
aliases) as symbol builders, as ``mxnet_tpu/symbol/contrib.py``."""
from __future__ import annotations


def __getattr__(name):
    from . import __getattr__ as _sym_getattr
    for candidate in ("_contrib_" + name, name):
        try:
            return _sym_getattr(candidate)
        except AttributeError:
            continue
    raise AttributeError("module 'symbol.contrib' has no attribute %r"
                         % name)
