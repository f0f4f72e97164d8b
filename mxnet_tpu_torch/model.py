"""Checkpoints, kvstore selection and ``FeedForward``.

Counterpart of ``mxnet_tpu/model.py``: ``save_checkpoint`` writes
``prefix-symbol.json`` and ``prefix-%04d.params`` (``arg:``/``aux:``
keys, the JAX package's npz format), each file atomically, and
``load_checkpoint`` reads them back, so the checkpoints of either package
load in the other.  ``_create_kvstore`` decides, as the JAX package's,
whether ``Module`` updates through a store (``kvstore.py``) or locally:
one context with a non-``dist`` store updates locally.
"""
from __future__ import annotations

import logging
from typing import Dict

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward",
           "BatchEndParam"]


class BatchEndParam:
    """What a batch-end callback receives."""

    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch=0, nbatch=0, eval_metric=None, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _create_kvstore(kvstore, num_device, arg_params):
    """A kvstore spec as ``(kv, update_on_kvstore)``."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(p.size for p in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Push the initial weights into the store."""
    for idx, param in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient and pull its weight back (the store updates)."""
    for index, (w, g) in enumerate(zip(param_arrays, grad_arrays)):
        if g is None:
            continue
        kvstore.push(index, g, priority=-index)
        kvstore.pull(index, w, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local update: reduce through the store where there is one, then
    ``updater(index, grad, weight)``."""
    for index, (w, g) in enumerate(zip(param_arrays, grad_arrays)):
        if g is None:
            continue
        if kvstore is not None:
            kvstore.push(index, g, priority=-index)
            kvstore.pull(index, g, priority=-index)
        updater(index, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, each
    through a temporary file and ``os.replace``, so a crash leaves an
    earlier checkpoint at the same path whole."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``, the arrays on the current
    context."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params: Dict[str, nd.NDArray] = {}
    aux_params: Dict[str, nd.NDArray] = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API, over ``mx.mod.Module``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.numpy_batch_size = numpy_batch_size
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .module import Module
        from .io import NDArrayIter
        train_data = X if not hasattr(X, "shape") else NDArrayIter(
            X, y, batch_size=self.numpy_batch_size)
        mod = Module(self.symbol,
                     data_names=[d.name if hasattr(d, "name") else d[0]
                                 for d in train_data.provide_data],
                     label_names=[d.name if hasattr(d, "name") else d[0]
                                  for d in train_data.provide_label],
                     context=self.ctx)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=self.kwargs,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None):
        assert self._module is not None, "call fit first"
        return self._module.predict(X, num_batch=num_batch)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else
                        (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})
