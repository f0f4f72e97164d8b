"""Vision datasets read from local files: MNIST, FashionMNIST (idx files,
plain or gzipped), CIFAR10 and CIFAR100 (the python-pickle batches).

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``.  Nothing is
downloaded: ``root`` must hold the standard files, and a missing one
raises ``IOError`` naming what was looked for.  The images are one
NDArray on the current context, (N, H, W, C) uint8; the labels a numpy
int32 vector.  ``ImageRecordDataset`` and ``ImageFolderDataset`` wait
with ``recordio`` and ``image`` (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as onp

from ....base import MXNetError
from ....ndarray import array
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """A dataset of files under ``root``; ``transform(data, label)`` is
    applied to each sample."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError("bad idx3 magic in %s" % path)
        return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(
            num, rows, cols, 1)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError("bad idx1 magic in %s" % path)
        return onp.frombuffer(f.read(), dtype=onp.uint8).astype(onp.int32)


def _find(root, names):
    for n in names:
        for cand in (os.path.join(root, n), os.path.join(root, n + ".gz")):
            if os.path.exists(cand):
                return cand
    raise IOError(
        "Dataset file not found under %s (looked for %s). Nothing is "
        "downloaded: place the standard files there." % (root, names))


class MNIST(_DownloadedDataset):
    """MNIST's idx files (``train-*`` or ``t10k-*``)."""

    _train_images = ["train-images-idx3-ubyte"]
    _train_labels = ["train-labels-idx1-ubyte"]
    _test_images = ["t10k-images-idx3-ubyte"]
    _test_labels = ["t10k-labels-idx1-ubyte"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        images = _find(self._root, self._train_images if self._train
                       else self._test_images)
        labels = _find(self._root, self._train_labels if self._train
                       else self._test_labels)
        self._label = _read_idx_labels(labels)
        self._data = array(_read_idx_images(images))


class FashionMNIST(MNIST):
    """FashionMNIST: MNIST's format under its own root."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10's python-pickle batches (``data_batch_1``..``5`` or
    ``test_batch``), in ``root`` or its ``cifar-10-batches-py``."""

    _train_files = ["data_batch_1", "data_batch_2", "data_batch_3",
                    "data_batch_4", "data_batch_5"]
    _test_files = ["test_batch"]
    _label_key = b"labels"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_batch(self, path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = onp.asarray(d[self._label_key], onp.int32)
        return data, labels

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        sub = None
        for cand in (self._root,
                     os.path.join(self._root, "cifar-10-batches-py"),
                     os.path.join(self._root, "cifar-100-python")):
            if os.path.exists(os.path.join(cand, files[0])):
                sub = cand
                break
        if sub is None:
            raise IOError(
                "CIFAR batches not found under %s. Nothing is downloaded: "
                "place the python-format batches there." % self._root)
        parts = [self._load_batch(os.path.join(sub, f)) for f in files]
        self._data = array(onp.concatenate([p[0] for p in parts]))
        self._label = onp.concatenate([p[1] for p in parts])


class CIFAR100(CIFAR10):
    """CIFAR100's ``train``/``test`` pickles, with the coarse labels or
    (``fine_label``) the fine ones."""

    _train_files = ["train"]
    _test_files = ["test"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._label_key = b"fine_labels" if fine_label else b"coarse_labels"
        super().__init__(root, train, transform)


def _waits(what):
    return MXNetError("%s is not ported yet: it waits with recordio and "
                      "image (ROADMAP.md, queue 1, item 7)" % what)


class ImageRecordDataset(Dataset):
    """Images and labels of a RecordIO pack; waits with ``recordio``."""

    def __init__(self, filename, flag=1, transform=None):
        raise _waits("ImageRecordDataset")


class ImageFolderDataset(Dataset):
    """Images of a ``root/label/image`` tree; waits with ``image``."""

    def __init__(self, root, flag=1, transform=None):
        raise _waits("ImageFolderDataset")
