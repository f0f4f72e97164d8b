"""BucketingModule: training over variable-length sequences with one set
of parameters.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``: ``sym_gen(key)``
gives each bucket's graph, and each bucket is a ``Module`` bound with the
default bucket's module as ``shared_module``, so every bucket's Executor
holds the same parameter NDArrays (one tensor each, not copies) and all
buckets share one optimizer and updater.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it first (sharing
        the default bucket's parameters) if it is new."""
        assert self.binded
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad,
                        shared_module=self._buckets[
                            self._default_bucket_key],
                        grad_req=self._buckets[
                            self._default_bucket_key]._grad_req)
            if self.params_initialized:
                module.params_initialized = True
            if self._opt_args is not None and not \
                    module.optimizer_initialized:
                self._share_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def get_params(self):
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self.params_initialized = True

    def _share_optimizer(self, module):
        """Every bucket updates the same parameters, so all share one
        optimizer, store and updater (its states are per index)."""
        main = self._buckets[self._default_bucket_key]
        module._optimizer = main._optimizer
        module._kvstore = main._kvstore
        module._updater = main._updater
        module._update_on_kvstore = main._update_on_kvstore
        module.optimizer_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._opt_args = (kvstore, optimizer, optimizer_params)
        self._buckets[self._default_bucket_key].init_optimizer(
            kvstore=kvstore, optimizer=optimizer,
            optimizer_params=optimizer_params, force_init=force_init)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded
        self.switch_bucket(data_batch.bucket_key
                           if data_batch.bucket_key is not None
                           else self._default_bucket_key,
                           data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        for mod in self._buckets.values():
            mod.install_monitor(mon)
