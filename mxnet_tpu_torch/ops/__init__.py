"""Operators on torch tensors (counterpart of ``mxnet_tpu/ops``).
Importing this package registers every op with ``ops/registry.py``."""
from . import registry  # noqa: F401
from . import fused_norm  # noqa: F401
from . import layernorm  # noqa: F401
from . import attention  # noqa: F401
from . import nn  # noqa: F401
from . import matrix  # noqa: F401
from . import elemwise  # noqa: F401
from . import random_ops  # noqa: F401
from . import reduce  # noqa: F401
from . import rnn  # noqa: F401
from . import control_flow  # noqa: F401
from . import contrib_ops  # noqa: F401
