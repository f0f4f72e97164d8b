"""Contrib (counterpart of ``mxnet_tpu/contrib``): automatic mixed
precision (``amp``) and the text vocabulary and token counting
(``text``).  The other contrib modules wait."""
from . import amp  # noqa: F401
from . import text  # noqa: F401
