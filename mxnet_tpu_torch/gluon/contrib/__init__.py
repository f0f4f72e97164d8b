"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the
transformer blocks.  The contrib CNN, RNN, data and estimator modules
wait."""
from . import nn  # noqa: F401
