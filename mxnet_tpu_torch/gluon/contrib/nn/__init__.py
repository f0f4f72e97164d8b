"""Contrib neural-network layers (counterpart of
``mxnet_tpu/gluon/contrib/nn``): the contrib basic layers and the
transformer blocks."""
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic_all
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer_all

__all__ = list(_basic_all) + list(_transformer_all)
