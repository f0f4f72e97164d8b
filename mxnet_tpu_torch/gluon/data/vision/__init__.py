"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import (  # noqa: F401
    MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset,
    ImageFolderDataset)
from . import transforms  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
