"""Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
ResNet v1 family and the BERT encoders; the other vision nets come with
later slices."""
from . import vision  # noqa: F401
from .bert import BERTModel, bert_base, bert_small  # noqa: F401

__all__ = ["vision", "BERTModel", "bert_base", "bert_small"]
