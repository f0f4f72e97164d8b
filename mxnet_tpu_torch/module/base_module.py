"""BaseModule: the train, evaluate and predict loops over the
intermediate API.

Counterpart of ``mxnet_tpu/module/base_module.py``: ``fit``, ``score``,
``predict`` and ``forward_backward`` with the reference's callback and
metric plumbing.  Subclasses supply ``bind``, ``init_params``,
``init_optimizer``, ``forward``, ``backward``, ``update`` and
``update_metric``.  Each training step's host time feeds the
``module.step`` histogram (``telemetry.span_event``); the JAX package's
elastic recovery hook (``fit(elastic=...)``) waits with
``parallel/elastic.py`` and raises (ROADMAP.md, queue 1, item 8).
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import telemetry
from ..base import MXNetError
from ..model import BatchEndParam


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- properties subclasses must provide -----------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    # -- one-step convenience -------------------------------------------
    def forward_backward(self, data_batch):
        """``forward`` in training, then ``backward``."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """Predict over ``eval_data`` and update ``eval_metric``: its
        ``(name, value)`` pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
            actual_num_batch += 1
        if score_end_callback is not None:
            param = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data``, each batch's padding cut off,
        concatenated along the batch (``merge_batches``)."""
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            outputs = [out[0:out.shape[0] - pad] for out in
                       self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    "Cannot merge batches: different numbers of outputs"
            output_list2 = [nd.concat(*[out[i] for out in output_list],
                                      dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, elastic=None):
        """Bind, initialize, then train ``num_epoch - begin_epoch`` epochs:
        each batch forward, backward, update, metric and batch-end
        callbacks; each epoch the epoch-end callbacks (with the symbol and
        the parameters) and the validation score."""
        from .. import initializer as init_mod
        assert num_epoch is not None, "please specify number of epochs"
        if elastic is not None:
            raise MXNetError("Module.fit(elastic=...) needs "
                             "parallel/elastic.py, which is not ported "
                             "(ROADMAP.md, queue 1, item 8)")
        if initializer is None:
            initializer = init_mod.Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            end_of_batch = False
            data_iter = iter(train_data)
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                t0 = time.perf_counter()
                self.forward_backward(data_batch)
                self.update()
                telemetry.span_event("module.step", time.perf_counter() - t0,
                                     hist=True, epoch=epoch, nbatch=nbatch)
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1

            for name, val in eval_metric.get_global_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p, allow_missing=False,
                            force_init=True, allow_extra=False)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # -- the intermediate API -------------------------------------------
    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
