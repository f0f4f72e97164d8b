"""Contrib (counterpart of ``mxnet_tpu/contrib``): the text vocabulary
and token counting (``text``).  The other contrib modules wait."""
from . import text  # noqa: F401
