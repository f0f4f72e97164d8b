"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``LibSVMIter`` and ``MNISTIter``.

Counterpart of the same classes in ``mxnet_tpu/io/io.py``.  ``NDArrayIter``
batches in-memory arrays by index arithmetic alone: each batch gathers an
index vector, ``shuffle`` permutes the order at every ``reset``, ``pad``
wraps the last batch around to the front of the epoch, ``discard`` drops
it and ``roll_over`` carries its indices into the next epoch.  The
permutation is drawn from the port's host ``torch.Generator``
(``mx.random.seed`` sets it), so it differs from the JAX package's numpy
shuffle; unshuffled, the two give the same batches.  A batch is an NDArray
on the current context (``gpu(0)`` unless a ``with mx.cpu():`` scope is
open).  ``PrefetchingIter`` runs one producer thread per child, under the
context that was current when its epoch began; ``CSVIter``, ``LibSVMIter``
(zero-based indices, dense batches) and ``MNISTIter`` (idx files, plain
or gzipped) read their files on the host into an ``NDArrayIter``.  The
record iterators wait (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

import queue
import threading
from collections import namedtuple

import numpy as onp
import torch

from .. import random as _random
from ..context import current_context
from ..ndarray import NDArray, array
from ..ndarray.ndarray import _wrap

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter"]


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

    @staticmethod
    def get_batch_axis(layout):
        """The position of the batch axis ``N`` in a layout string."""
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        """Descriptors from (name, shape) pairs and optional (name, dtype)
        pairs."""
        dtypes = dict(types) if types is not None else {}
        return [DataDesc(name, shape, dtypes[name]) if name in dtypes
                else DataDesc(name, shape) for name, shape in shapes]


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


class _DelegatesToCurrentBatch(DataIter):
    """The pull-style accessors read ``self.current_batch``."""

    current_batch = None

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label


class ResizeIter(_DelegatesToCurrentBatch):
    """Exactly ``size`` batches an epoch from ``data_iter``, which is
    reset whenever it runs out (and at every ``reset`` unless
    ``reset_internal`` is false)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter, self.size = data_iter, size
        self.reset_internal, self.cur = reset_internal, 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur >= self.size:
            return False
        try:
            self.current_batch = next(self.data_iter)
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = next(self.data_iter)
        self.cur += 1
        return True


class _Producer:
    """A thread pulling one epoch of batches from a child iterator into a
    queue of depth 1, under the context current at its start; ``None``
    marks the epoch's end.  A new epoch gets a new producer, so the child
    is never reset while the thread may be inside ``next``."""

    def __init__(self, it):
        self.it = it
        self.out = queue.Queue(maxsize=1)
        self._resume = threading.Event()
        self._resume.set()
        self._alive = True
        self._exhausted = False
        self._ctx = current_context()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        with self._ctx:
            while True:
                self._resume.wait()
                if not self._alive:
                    return
                try:
                    self.out.put(next(self.it))
                except StopIteration:
                    self._resume.clear()
                    self.out.put(None)

    def fetch(self):
        if self._exhausted:
            return None
        item = self.out.get()
        if item is None:
            self._exhausted = True
        return item

    def stop(self):
        self._alive = False
        self._resume.set()

    def stop_and_join(self):
        """End the thread, draining the queue so that a blocked ``put``
        completes; returns with the thread gone and the child idle."""
        self.stop()
        while self.thread.is_alive():
            try:
                self.out.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)


class PrefetchingIter(_DelegatesToCurrentBatch):
    """Batches produced ahead on background threads, one per child
    iterator; several children are zipped into one batch (their data,
    then their labels), renamed by ``rename_data``/``rename_label``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        iters = iters if isinstance(iters, list) else [iters]
        if not iters:
            raise ValueError("need at least one child iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        super().__init__(self.provide_data[0].shape[0])
        self._producers = [_Producer(it) for it in iters]

    def _renamed(self, descs_per_iter, renames):
        out = []
        for i, descs in enumerate(descs_per_iter):
            for d in descs:
                d = d if isinstance(d, DataDesc) else DataDesc(*d)
                if renames is not None:
                    d = DataDesc(renames[i][d.name], d.shape, d.dtype)
                out.append(d)
        return out

    @property
    def provide_data(self):
        return self._renamed([it.provide_data for it in self.iters],
                             self.rename_data)

    @property
    def provide_label(self):
        return self._renamed([it.provide_label for it in self.iters],
                             self.rename_label)

    def reset(self):
        # the epoch's producers end before any child is reset: a child
        # reset while its thread is inside next() could hand out a batch
        # of the old epoch
        for p in self._producers:
            p.stop_and_join()
        for it in self.iters:
            it.reset()
        self._producers = [_Producer(it) for it in self.iters]

    def __del__(self):
        for p in getattr(self, "_producers", []):
            p.stop()

    def iter_next(self):
        batches = [p.fetch() for p in self._producers]
        done = [b is None for b in batches]
        if any(done):
            if not all(done):
                raise ValueError("the child iterators disagree on the "
                                 "epoch's length")
            return False
        if len({b.pad for b in batches}) != 1:
            raise ValueError("the child iterators disagree on the padding")
        self.current_batch = DataBatch(
            [a for b in batches for a in b.data],
            [a for b in batches for a in b.label],
            batches[0].pad, batches[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        return True


class CSVIter(NDArrayIter):
    """Rows of a CSV file (and of a label file), reshaped to ``data_shape``
    (``label_shape``), batched as ``NDArrayIter`` batches."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, dtype="float32", **kwargs):
        data = onp.loadtxt(data_csv, delimiter=",", dtype=dtype)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=dtype)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size, **kwargs)


def _parse_libsvm(path, num_features):
    """(dense data, labels) of a libsvm text file: lines
    ``label idx:val idx:val ...`` with zero-based indices, a label list
    comma-separated for several labels."""
    rows, labels = [], []
    width = 0
    with open(path) as fin:
        for line in fin:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            feats = [p for p in parts if ":" in p]
            labs = parts[:len(parts) - len(feats)]
            lab = [float(v) for v in (labs[0].split(",") if labs else ["0"])]
            width = max(width, len(lab))
            row = onp.zeros(num_features, "float32")
            for p in feats:
                i, v = p.split(":")
                i = int(i)
                if not 0 <= i < num_features:
                    raise ValueError(
                        "libsvm index %d out of range for data_shape %d "
                        "(indices are zero-based)" % (i, num_features))
                row[i] = float(v)
            rows.append(row)
            labels.append(lab)
    data = onp.stack(rows) if rows else onp.zeros((0, num_features),
                                                  "float32")
    lab_arr = onp.zeros((len(labels), width or 1), "float32")
    for r, lab in enumerate(labels):
        lab_arr[r, :len(lab)] = lab
    return data, lab_arr


class LibSVMIter(NDArrayIter):
    """A libsvm file's rows as dense batches (the JAX package's sparse
    arrays are dense too), labels inline or from ``label_libsvm``;
    ``round_batch`` pads the last batch, else it is dropped."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True, **kwargs):
        nfeat = int(onp.prod(data_shape))
        data, inline_label = _parse_libsvm(data_libsvm, nfeat)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_libsvm is not None:
            nlab = int(onp.prod(label_shape)) if label_shape else 1
            label, _ = _parse_libsvm(label_libsvm, nlab)
            if label_shape:
                label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = inline_label
            if label.shape[-1] == 1:
                label = label[:, 0]
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", **kwargs)


class MNISTIter(NDArrayIter):
    """MNIST's idx files (or their ``.gz``), pixels scaled to [0, 1],
    (N, 784) with ``flat`` else (N, 1, rows, cols); the last partial batch
    is dropped.  ``seed`` and ``silent`` are accepted; a shuffle draws
    from the port's host generator."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0, **kwargs):
        import gzip
        import os
        import struct

        def _open(path):
            if os.path.exists(path):
                return open(path, "rb")
            if os.path.exists(path + ".gz"):
                return gzip.open(path + ".gz", "rb")
            raise IOError("MNIST file %s not found" % path)

        with _open(image) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError("bad MNIST image magic")
            img = onp.frombuffer(f.read(), dtype=onp.uint8).reshape(
                num, rows, cols).astype("float32") / 255.0
        with _open(label) as f:
            magic, num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError("bad MNIST label magic")
            lab = onp.frombuffer(f.read(), dtype=onp.uint8).astype("float32")
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, rows, cols)
        super().__init__(img, lab, batch_size=batch_size, shuffle=shuffle,
                         last_batch_handle="discard", **kwargs)
