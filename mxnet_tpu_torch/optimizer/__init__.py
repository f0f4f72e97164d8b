"""Optimizers (counterpart of ``mxnet_tpu/optimizer``): the sixteen rules
over ``torch._foreach_*`` updates, and the Updater that owns their
states."""
from .optimizer import (  # noqa: F401
    Optimizer, Updater, get_updater, create, register,
    SGD, Signum, FTML, LBSGD, DCASGD, NAG, SGLD, Adam, AdamW, AdaGrad,
    RMSProp, AdaDelta, Ftrl, Adamax, Nadam, Test,
)

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG", "SGLD", "Adam",
           "AdamW", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "Test"]
