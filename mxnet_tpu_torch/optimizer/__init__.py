"""Optimizers (counterpart of ``mxnet_tpu/optimizer``): SGD, NAG and Adam
over ``torch._foreach_*`` updates, and the Updater that owns their states."""
from .optimizer import (  # noqa: F401
    Optimizer, Updater, get_updater, create, register, SGD, NAG, Adam)

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "NAG", "Adam"]
