"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the contrib
layers and transformer blocks (``nn``), the variational-dropout and LSTMP
cells (``rnn``), the text datasets and interval sampler (``data``) and
the Estimator with its event handlers (``estimator``).  The contrib CNN
module and the convolutional cells wait."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
from . import estimator  # noqa: F401
