"""Text utilities: the vocabulary and token counting (counterpart of
``mxnet_tpu/contrib/text``, whose ``vocab.py`` and ``utils.py`` are
copied here; the token embeddings wait)."""
from . import utils  # noqa: F401
from . import vocab  # noqa: F401
from .vocab import Vocabulary  # noqa: F401

__all__ = ["utils", "vocab", "Vocabulary"]
