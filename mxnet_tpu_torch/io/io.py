"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter``.

Counterpart of the same classes in ``mxnet_tpu/io/io.py``.  ``NDArrayIter``
batches in-memory arrays by index arithmetic alone: each batch gathers an
index vector, ``shuffle`` permutes the order at every ``reset``, ``pad``
wraps the last batch around to the front of the epoch, ``discard`` drops
it and ``roll_over`` carries its indices into the next epoch.  The
permutation is drawn from the port's host ``torch.Generator``
(``mx.random.seed`` sets it), so it differs from the JAX package's numpy
shuffle; unshuffled, the two give the same batches.  A batch is an NDArray
on the current context (``gpu(0)`` unless a ``with mx.cpu():`` scope is
open).  The prefetching and record iterators come with later slices.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as onp
import torch

from .. import random as _random
from ..ndarray import NDArray, array
from ..ndarray.ndarray import _wrap

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Named (shape, dtype, layout) descriptor of one input slot;
    tuple-compatible: ``name, shape = desc``."""

    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        desc = super().__new__(cls, name, shape)
        desc.dtype = dtype
        desc.layout = layout
        return desc

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch:
    """One mini-batch of data and label arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        for arrs, what in ((data, "Data"), (label, "Label")):
            if arrs is not None and not isinstance(arrs, (list, tuple)):
                raise ValueError("%s must be list of NDArrays" % what)
        self.data, self.label = data, label
        self.pad, self.index = pad, index
        self.bucket_key = bucket_key
        self.provide_data, self.provide_label = provide_data, provide_label

    def __str__(self):
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, [d.shape for d in self.data],
            [l.shape for l in self.label] if self.label else None)


class DataIter:
    """The iterator protocol: subclasses implement ``iter_next``,
    ``getdata``, ``getlabel`` and ``getpad``, or ``next`` as a whole."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=self.getindex())

    def reset(self):
        pass

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _normalize_arrays(arrays, allow_empty, default_name):
    """[(name, array)] from a bare array, a list or a name -> array dict;
    numpy arrays are made contiguous, NDArrays kept as they are."""
    if arrays is None:
        if not allow_empty:
            raise ValueError("data may not be None")
        named = []
    elif isinstance(arrays, dict):
        named = list(arrays.items())
    else:
        if isinstance(arrays, (onp.ndarray, NDArray)):
            arrays = [arrays]
        if not isinstance(arrays, (list, tuple)):
            raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                            "them or dict with them as values")
        if not allow_empty and not arrays:
            raise ValueError("at least one array required")
        if len(arrays) == 1:
            named = [(default_name, arrays[0])]
        else:
            named = [("_%d_%s" % (i, default_name), a)
                     for i, a in enumerate(arrays)]
    return [(name, arr if isinstance(arr, NDArray)
             else onp.ascontiguousarray(arr)) for name, arr in named]


def _gather(arr, indices):
    """Rows ``indices`` of numpy or NDArray storage as an NDArray."""
    if isinstance(arr, NDArray):
        return _wrap(arr._data[torch.as_tensor(indices,
                                               device=arr._data.device)])
    return array(arr[indices])


class NDArrayIter(DataIter):
    """Batches over in-memory arrays (a dict, a list or one array of data
    and of labels), with ``shuffle`` and the ``pad``/``discard``/
    ``roll_over`` last-batch policies."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be 'pad', 'discard' or "
                             "'roll_over', got %r" % (last_batch_handle,))
        self.data = _normalize_arrays(data, False, data_name)
        self.label = _normalize_arrays(label, True, label_name)
        self.num_data = int(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._carry = None          # roll_over leftovers (index vector)
        self._order = None
        self._pos = 0
        self._batch_indices = None
        self._batch_pad = 0
        self.reset()

    def _new_order(self):
        if self.shuffle:
            return torch.randperm(self.num_data,
                                  generator=_random.generator("cpu")).numpy()
        return onp.arange(self.num_data, dtype=onp.int64)

    def reset(self):
        order = self._new_order()
        if self.last_batch_handle == "roll_over" and self._carry is not None:
            order = onp.concatenate([self._carry, order])
            self._carry = None
        self._order = order
        self._pos = 0
        self._batch_indices = None

    def hard_reset(self):
        """Reset, dropping any roll_over carry."""
        self._carry = None
        self.reset()

    def iter_next(self):
        take = self._order[self._pos:self._pos + self.batch_size]
        if take.size == 0:
            return False
        self._batch_pad = self.batch_size - take.size
        if self._batch_pad:
            if self.last_batch_handle == "discard":
                return False
            if self.last_batch_handle == "roll_over":
                self._carry = take
                return False
            take = onp.concatenate([take, self._order[:self._batch_pad]])
        self._batch_indices = take
        self._pos += self.batch_size
        return True

    def getdata(self):
        return [_gather(arr, self._batch_indices) for _, arr in self.data]

    def getlabel(self):
        return [_gather(arr, self._batch_indices) for _, arr in self.label]

    def getpad(self):
        return self._batch_pad

    def _descs(self, named):
        return [DataDesc(name, (self.batch_size,) + tuple(arr.shape[1:]),
                         arr.dtype) for name, arr in named]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)
