"""Contrib datasets and samplers (counterpart of
``mxnet_tpu/gluon/contrib/data``)."""
from .sampler import *  # noqa: F401,F403
from . import sampler
from . import text  # noqa: F401
from .text import LanguageModelDataset, WikiText2, WikiText103  # noqa: F401

__all__ = list(sampler.__all__) + ["text", "LanguageModelDataset",
                                   "WikiText2", "WikiText103"]
