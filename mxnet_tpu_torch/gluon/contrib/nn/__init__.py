"""Contrib neural-network layers (counterpart of
``mxnet_tpu/gluon/contrib/nn``): the transformer blocks.  The contrib
basic layers wait."""
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer_all

__all__ = list(_transformer_all)
