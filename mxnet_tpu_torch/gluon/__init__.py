"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters, layers,
the recurrent layers and cells (``rnn``), ``SymbolBlock``, losses, the
Trainer, the data API, the contrib layers, transformer blocks, recurrent
cells and text datasets (``contrib``), the vision, BERT and LM model zoo,
batch splitting and the JAX-weight loader."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import contrib  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
from . import loss  # noqa: F401
from . import data  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (  # noqa: F401
    Constant, DeferredInitializationError, Parameter, ParameterDict)
from .trainer import Trainer  # noqa: F401
from .utils import split_and_load, split_data  # noqa: F401

__all__ = ["nn", "rnn", "contrib", "utils", "model_zoo", "loss", "data",
           "Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "ParameterDict",
           "DeferredInitializationError", "Trainer", "split_data",
           "split_and_load"]
