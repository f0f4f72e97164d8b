"""DataLoader: batches of a Dataset, in this process, in worker processes
or on a pool of threads.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``:

* ``num_workers=0``: samples are read in the sampler's order and stacked
  by ``default_batchify_fn`` into NDArrays on the current context.
* ``num_workers > 0``: a pool of worker processes, started with ``spawn``
  (``MXNET_MP_START_METHOD`` names another method).  Each worker reads and
  batches in numpy only, under an explicit ``cpu()`` context, and hands
  each batch back through ``multiprocessing.shared_memory`` segments, so
  only (name, shape, dtype) crosses the pipe.  The workers never touch a
  card: they start with no CUDA device visible and without the process
  group's coordinator address.  The parent copies each batch out of its
  segments, unlinks them, and wraps it on its own current context, so a
  batch lands on ``gpu(0)`` unless a ``with mx.cpu():`` scope is open.
  ``prefetch`` batches (default ``2 * num_workers``) are in flight; a
  consumer that stops early has the segments of the batches it never took
  unlinked (``_reclaim``), and ``close`` ends the pool.
* ``thread_pool=True`` (or a dataset that cannot be pickled): a pool of
  threads, each batching under the context current when iteration began.

``pin_memory`` is accepted, as the JAX package accepts it; a batch is
copied to the card from pageable memory.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as onp

from ...context import cpu, current_context
from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch; tuple samples give a list of batches."""
    if isinstance(data[0], NDArray):
        return array(onp.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    return array(onp.asarray(data))


# ---------------------------------------------------------------------------
# the worker processes (module level: spawn pickles these by name)
# ---------------------------------------------------------------------------

_WORKER_DATASET = None
_WORKER_BATCHIFY = None
# what a worker must not inherit: a card, and the process group's address
_CHILD_ENV = {"CUDA_VISIBLE_DEVICES": ""}
_CHILD_UNSET = ("MXNET_TPU_COORDINATOR_ADDRESS", "MXNET_TPU_NUM_PROCESSES",
                "MXNET_TPU_PROCESS_ID")


def _to_numpy_tree(obj):
    """NDArrays (nested in lists and tuples) as numpy arrays."""
    if isinstance(obj, NDArray):
        return obj.asnumpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(o) for o in obj)
    return onp.asarray(obj)


def _numpy_batchify(data):
    """``default_batchify_fn`` in numpy."""
    if isinstance(data[0], (list, tuple)):
        return [_numpy_batchify(list(x)) for x in zip(*data)]
    return onp.stack([onp.asarray(d) for d in data])


def _worker_initializer(dataset, batchify_fn):
    global _WORKER_DATASET, _WORKER_BATCHIFY
    _WORKER_DATASET = dataset
    _WORKER_BATCHIFY = batchify_fn


def _shm_export(arr):
    """One numpy array copied into a new shared-memory segment; returns
    its metadata.  The parent unlinks the segment."""
    from multiprocessing import resource_tracker, shared_memory
    arr = onp.ascontiguousarray(arr)
    shm = shared_memory.SharedMemory(create=True, size=max(1, arr.nbytes))
    onp.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    meta = ("shm", shm.name, arr.shape, str(arr.dtype))
    # this process's resource tracker must not free what the parent owns
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return meta


def _shm_export_tree(obj):
    if isinstance(obj, onp.ndarray):
        return _shm_export(obj)
    if isinstance(obj, (list, tuple)):
        return ("tree", [_shm_export_tree(o) for o in obj])
    return ("obj", obj)


def _shm_import_tree(meta, wrap):
    kind = meta[0]
    if kind == "shm":
        from multiprocessing import shared_memory
        _, name, shape, dtype = meta
        shm = shared_memory.SharedMemory(name=name)
        try:
            arr = onp.ndarray(shape, dtype, buffer=shm.buf).copy()
        finally:
            shm.close()
            shm.unlink()
        return wrap(arr)
    if kind == "tree":
        return [_shm_import_tree(m, wrap) for m in meta[1]]
    return meta[1]


def _unlink_tree(meta):
    """Free the segments of a batch that will never be taken."""
    kind = meta[0]
    if kind == "shm":
        from multiprocessing import shared_memory
        try:
            seg = shared_memory.SharedMemory(name=meta[1])
        except FileNotFoundError:
            return
        seg.close()
        seg.unlink()
    elif kind == "tree":
        for m in meta[1]:
            _unlink_tree(m)


def _worker_fn(indices):
    with cpu():
        samples = [_WORKER_DATASET[i] for i in indices]
        if _WORKER_BATCHIFY is not None:
            batch = _to_numpy_tree(_WORKER_BATCHIFY(samples))
        else:
            batch = _numpy_batchify([_to_numpy_tree(s) for s in samples])
    return _shm_export_tree(batch)


class DataLoader:
    """Batches of a Dataset, from ``batch_size`` with ``shuffle`` or a
    ``sampler``, or from a ``batch_sampler``; ``num_workers`` worker
    processes (or threads, ``thread_pool``) with ``prefetch`` batches in
    flight."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn
        self._thread_pool = thread_pool
        self._executor = None
        self._pool = None
        self._live_inflight = []   # each open iterator's batches in flight
        if self._num_workers > 0:
            if not thread_pool:
                import pickle
                try:   # spawned workers get the dataset pickled
                    pickle.dumps((self._dataset, self._batchify_fn))
                except Exception:
                    import warnings
                    warnings.warn(
                        "DataLoader: dataset or batchify_fn is not "
                        "picklable; falling back to thread workers",
                        stacklevel=2)
                    thread_pool = True
            if thread_pool:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._num_workers)
            else:
                self._pool = self._create_pool()

    def _create_pool(self):
        import multiprocessing as mp
        method = os.environ.get("MXNET_MP_START_METHOD", "spawn")
        ctx = mp.get_context(method)
        saved = {k: os.environ.get(k)
                 for k in list(_CHILD_ENV) + list(_CHILD_UNSET)}
        os.environ.update(_CHILD_ENV)
        for k in _CHILD_UNSET:
            os.environ.pop(k, None)
        try:
            return ctx.Pool(self._num_workers,
                            initializer=_worker_initializer,
                            initargs=(self._dataset, self._batchify_fn))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _make_batch(self, indices):
        fn = self._batchify_fn or default_batchify_fn
        return fn([self._dataset[i] for i in indices])

    def _make_batch_in(self, ctx, indices):
        with ctx:
            return self._make_batch(indices)

    def __iter__(self):
        if self._pool is not None:
            yield from self._iter_mp()
            return
        if self._executor is None:
            for batch_indices in self._batch_sampler:
                yield self._make_batch(batch_indices)
            return
        # a thread's context is its own: it batches under the caller's
        ctx = current_context()
        batches = iter(self._batch_sampler)
        futures = []
        try:
            for _ in range(self._prefetch + 1):
                futures.append(self._executor.submit(
                    self._make_batch_in, ctx, next(batches)))
        except StopIteration:
            pass
        while futures:
            f = futures.pop(0)
            try:
                futures.append(self._executor.submit(
                    self._make_batch_in, ctx, next(batches)))
            except StopIteration:
                pass
            yield f.result()

    @staticmethod
    def _reclaim(inflight):
        """Unlink the segments of batches made but never taken."""
        for res in inflight:
            try:
                meta = res.get(timeout=10)
            except Exception:
                continue   # the worker died or was ended: no segment
            _unlink_tree(meta)
        inflight.clear()

    def _iter_mp(self):
        batches = iter(self._batch_sampler)
        inflight = []
        self._live_inflight.append(inflight)
        try:
            try:
                for _ in range(self._prefetch + 1):
                    inflight.append(
                        self._pool.apply_async(_worker_fn, (next(batches),)))
            except StopIteration:
                pass
            while inflight:
                res = inflight.pop(0)
                try:
                    inflight.append(
                        self._pool.apply_async(_worker_fn, (next(batches),)))
                except StopIteration:
                    pass
                yield _shm_import_tree(res.get(), array)
        finally:
            # the consumer stopped, raised, or dropped the generator: the
            # segments already made would stay in /dev/shm
            self._reclaim(inflight)
            if inflight in self._live_inflight:
                self._live_inflight.remove(inflight)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """End the worker processes (or threads), unlinking the segments
        of every batch still in flight."""
        if self._pool is not None:
            for inflight in list(self._live_inflight):
                self._reclaim(inflight)
            self._live_inflight = []
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
