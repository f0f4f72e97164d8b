"""Datasets: ``Dataset``, ``SimpleDataset`` and ``ArrayDataset``.

Counterpart of the same classes in ``mxnet_tpu/gluon/data/dataset.py``,
with ``transform``/``transform_first``, ``filter``, ``take`` and
``shard``.  ``RecordFileDataset`` waits with ``recordio`` (ROADMAP.md,
queue 1, item 7).
"""
from __future__ import annotations

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn(sample)`` is true, as a
        SimpleDataset."""
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def shard(self, num_shards, index):
        """The ``index``-th of ``num_shards`` contiguous parts (the first
        ``len % num_shards`` parts one sample longer)."""
        if not 0 <= index < num_shards:
            raise ValueError("shard index %d out of range for %d shards"
                             % (index, num_shards))
        length = len(self)
        shard_len, rest = divmod(length, num_shards)
        start = shard_len * index + min(index, rest)
        return _RangeDataset(self, start, start + shard_len + (index < rest))

    def take(self, count):
        if count is None or count >= len(self):
            return self
        return _RangeDataset(self, 0, count)

    def transform(self, fn, lazy=True):
        """``fn`` applied to every sample (a tuple sample is unpacked)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` applied to the first element of every sample."""
        return self.transform(_TransformFirst(fn), lazy)


class _RangeDataset(Dataset):
    def __init__(self, dataset, start, end):
        self._dataset, self._start, self._end = dataset, start, end

    def __getitem__(self, idx):
        return self._dataset[self._start + idx]

    def __len__(self):
        return self._end - self._start


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset, self._fn = dataset, fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        return self._fn(*item) if isinstance(item, tuple) else self._fn(item)


class _TransformFirst:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        return (self._fn(x),) + args if args else self._fn(x)


class SimpleDataset(Dataset):
    """A list or array as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Equal-length arrays zipped: sample ``i`` is the tuple of their
    ``i``-th entries (the entry itself for one array).  A 1-D NDArray is
    kept as a numpy array, so its samples are numbers."""

    def __init__(self, *args):
        if not args:
            raise ValueError("Needs at least 1 arrays")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, i, len(data)))
            if isinstance(data, NDArray) and len(data.shape) == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length
