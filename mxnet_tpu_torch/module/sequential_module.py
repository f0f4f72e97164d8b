"""SequentialModule: modules chained end to end.

Counterpart of ``mxnet_tpu/module/sequential_module.py``: each child takes
the previous child's outputs as its data; labels go only to the children
added with ``take_labels=True``; ``auto_wiring`` renames a child's data to
the previous outputs.  Backward runs the chain in reverse, feeding each
child's input gradients to the one before it.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A container chaining modules."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append a module (meta keywords: ``take_labels``,
        ``auto_wiring``); returns self for chaining."""
        unknown = set(kwargs) - self._meta_keys
        if unknown:
            raise ValueError("unknown meta keys %s (valid: %s)"
                             % (sorted(unknown), sorted(self._meta_keys)))
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        # adding invalidates previous binding
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- shapes/names ---------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- params ---------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        # each child owns a SUBSET of the composite's params, so missing-
        # from-this-child is normal; honor the caller's allow_missing by
        # checking coverage across ALL children afterwards
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=True,
                               force_init=force_init, allow_extra=True)
        if not allow_missing and (arg_params or aux_params):
            all_names = set()
            for module in self._modules:
                arg, aux = module.get_params()
                all_names.update(arg)
                all_names.update(aux)
            given = set(arg_params or ()) | set(aux_params or ())
            missing = all_names - given
            if missing:
                raise ValueError(
                    "allow_missing=False but params %s were not provided "
                    "(they were freshly initialized)" % sorted(missing))

        # no parameter name may be shared across children: shared names
        # would silently desynchronize
        seen = {}
        for i, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for name in list(arg) + list(aux):
                if name in seen:
                    raise ValueError(
                        "duplicate parameter %r in modules %d and %d; "
                        "name children uniquely" % (name, seen[name], i))
                seen[name] = i
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        for module in self._modules:
            module.set_params(arg_params, aux_params, allow_missing=True,
                              force_init=force_init, allow_extra=True)
        self.params_initialized = True

    # -- graph ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None, \
            "shared_module is not supported for SequentialModule"
        assert self._modules, "add modules before binding"
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            my_labels = label_shapes if meta.get(self.META_TAKE_LABELS) \
                else None
            # intermediate children must produce input grads for the chain
            need_grad = inputs_need_grad if i == 0 else True
            if meta.get(self.META_AUTO_WIRING):
                names = module.data_names
                assert len(names) == len(my_data_shapes)
                my_data_shapes = [(new, shape) for new, (_, shape)
                                  in zip(names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_labels,
                        for_training=for_training,
                        inputs_need_grad=need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            # chain the next child off statically-inferred output shapes
            # (executor outputs only materialize after a forward)
            feed = {n: s for n, s in my_data_shapes}
            if my_labels:
                feed.update({n: s for n, s in my_labels})
            _, out_shapes, _ = module.symbol.infer_shape(**feed)
            my_data_shapes = list(zip(module.output_names, out_shapes))
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(module.get_outputs(),
                              label=data_batch.label,
                              pad=getattr(data_batch, "pad", None))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        grads = out_grads
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=grads)
            if i == 0:
                break
            grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
