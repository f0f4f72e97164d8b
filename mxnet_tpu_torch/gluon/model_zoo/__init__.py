"""Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
vision nets (``vision.get_model``), the BERT encoders and the LSTM
language models of ``lm`` (which the JAX package keeps in ``bench.py``
and ``example/``)."""
from . import vision  # noqa: F401
from . import lm  # noqa: F401
from .bert import BERTModel, bert_base, bert_small  # noqa: F401

__all__ = ["vision", "lm", "BERTModel", "bert_base", "bert_small"]
