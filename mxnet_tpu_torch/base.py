"""Base utilities: the framework error type, type tuples, the default
real type, environment settings and dtypes.

Counterpart of ``mxnet_tpu/base.py``.  The port keeps its own copy rather
than importing the JAX package.  ``torch_dtype`` is new here: it maps the
dtype spellings MXNet code uses (numpy dtypes, strings) onto torch dtypes.
"""
from __future__ import annotations

import os

import numpy as onp
import torch

__all__ = ["MXNetError", "string_types", "numeric_types", "integer_types",
           "mx_real_t", "get_env", "torch_dtype"]

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Default error type raised by the framework."""


string_types = (str,)
numeric_types = (float, int, onp.generic)
integer_types = (int, onp.integer)

# the default real type
mx_real_t = onp.float32

_TRUE = {"1", "true", "yes", "on"}


def get_env(name: str, default=None, typ=str):
    """The environment variable ``name`` as ``typ`` (a bool is true for
    1/true/yes/on), or ``default`` when it is unset."""
    val = os.environ.get(name)
    if val is None:
        return default
    if typ is bool:
        return val.lower() in _TRUE
    return typ(val)

_NAMED = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
          "uint8": torch.uint8, "bool": torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` for a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    if name not in _NAMED:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _NAMED[name]
