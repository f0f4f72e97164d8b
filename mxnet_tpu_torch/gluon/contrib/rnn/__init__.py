"""Contrib recurrent cells (counterpart of ``mxnet_tpu/gluon/contrib/rnn``):
``VariationalDropoutCell`` and ``LSTMPCell``.  The convolutional cells
(``conv_rnn_cell.py``) wait."""
from .rnn_cell import *  # noqa: F401,F403
from . import rnn_cell  # noqa: F401

__all__ = rnn_cell.__all__
