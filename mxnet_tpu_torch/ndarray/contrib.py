"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
the control-flow operators of ``ops/control_flow.py``.  The JAX package's
``isfinite``/``isnan``/``isinf`` and its forwarding of the registry's
``_contrib_<op>`` names wait."""
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401

__all__ = ["foreach", "while_loop", "cond"]
