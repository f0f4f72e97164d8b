"""Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
ResNet v1 family; the other vision nets and BERT come with later slices."""
from . import vision  # noqa: F401

__all__ = ["vision"]
