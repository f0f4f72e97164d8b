"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
the control-flow operators of ``ops/control_flow.py``, ``isfinite``,
``isnan`` and ``isinf`` (float32 masks, recorded by no tape), and every
registered ``_contrib_<op>`` under its short name."""
import torch

from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from .ndarray import _wrap

__all__ = ["foreach", "while_loop", "cond", "isfinite", "isnan", "isinf"]


def _mask(fn, data):
    with torch.no_grad():
        return _wrap(fn(data._data).to(torch.float32))


def isfinite(data):
    """1.0 where ``data`` is finite, else 0.0."""
    return _mask(torch.isfinite, data)


def isnan(data):
    """1.0 where ``data`` is NaN, else 0.0."""
    return _mask(torch.isnan, data)


def isinf(data):
    """1.0 where ``data`` is infinite, else 0.0."""
    return _mask(torch.isinf, data)


def __getattr__(name):
    """``mx.nd.contrib.<op>``: the registry's ``_contrib_<op>``, or
    ``<op>`` itself."""
    from . import __getattr__ as _nd_getattr
    for candidate in ("_contrib_" + name, name):
        try:
            return _nd_getattr(candidate)
        except AttributeError:
            continue
    raise AttributeError("module 'ndarray.contrib' has no attribute %r"
                         % name)
