"""Gluon Estimator: the ``fit``/``evaluate`` loops over a net, a loss,
metrics and a trainer, with event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import *  # noqa: F401,F403
from .event_handler import *  # noqa: F401,F403
from . import estimator, event_handler

__all__ = estimator.__all__ + event_handler.__all__
