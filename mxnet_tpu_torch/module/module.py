"""Module: the intermediate-level symbolic training interface.

Counterpart of ``mxnet_tpu/module/module.py``: ``bind`` infers every
shape and makes one ``Executor`` over zero arrays on the module's context
(sharing the parameter arrays of ``shared_module``, as the buckets of a
``BucketingModule`` do), ``init_params``/``set_params`` copy or initialize
the parameters, ``init_optimizer`` picks the store or the local updater as
``model.py`` decides, ``forward`` re-binds on a new batch shape, and
``update`` applies the optimizer.  One context only: the JAX package turns
a list of contexts into a ``dp`` mesh, which the port's data parallelism
offers through ``DataParallelStep``; more than one context raises
(ROADMAP.md, queue 1, item 6, "Data-parallel waits").
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..initializer import InitDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from .base_module import BaseModule, _as_list

__all__ = ["Module"]


class Module(BaseModule):
    """A symbolic training module over one Symbol."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        self._contexts = _as_list(context)
        if len(self._contexts) > 1:
            raise MXNetError(
                "Module over %d contexts: a dp mesh of Modules is not "
                "ported; train across cards with parallel.DataParallelStep "
                "(ROADMAP.md, queue 1, item 6, Data-parallel waits)"
                % len(self._contexts))
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        # the executors of earlier input shapes, and their graphs
        self._execs = {}
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        self._update_on_kvstore = None
        self._grad_req = "write"
        self._preloaded = None
        self._states_fname = None

    # -- introspection ---------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return list(zip(self.output_names,
                        [tuple(o.shape) for o in self._exec.outputs])) \
            if self._exec.outputs else None

    # -- binding ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Infer every shape from the data and label shapes, make the
        arrays on the module's context and the Executor over them.  With
        ``shared_module`` the parameter arrays (and auxiliary states) are
        that module's NDArrays, not copies."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        from .. import ndarray as nd

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        def _norm(shapes):
            out = []
            for s in shapes or []:
                if hasattr(s, "name"):
                    out.append((s.name, tuple(s.shape)))
                else:
                    out.append((s[0], tuple(s[1])))
            return out

        self._data_shapes = _norm(data_shapes)
        self._label_shapes = _norm(label_shapes)
        known = dict(self._data_shapes + self._label_shapes)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**known)
        arg_names = self._symbol.list_arguments()
        shape_of = dict(zip(arg_names, arg_shapes))
        ctx = self._contexts[0]

        shared_args = {}
        if shared_module is not None and shared_module._exec is not None:
            # parameters only: data and label arrays have each bucket's
            # shapes
            shared_args = {n: a for n, a in
                           shared_module._exec.arg_dict.items()
                           if n in shared_module._param_names}

        args, grads, reqs = [], [], []
        for name in arg_names:
            if name in shared_args:
                arr = shared_args[name]
            else:
                arr = nd.zeros(shape_of[name], ctx=ctx)
            args.append(arr)
            if name in self._data_names:
                req = "write" if (for_training and inputs_need_grad) \
                    else "null"
            elif name in self._label_names or not for_training \
                    or name in self._fixed_param_names:
                req = "null"
            elif isinstance(grad_req, dict):
                req = grad_req.get(name, "write")
            else:
                req = grad_req
            reqs.append(req)
            grads.append(nd.zeros(shape_of[name], ctx=ctx)
                         if req != "null" else None)
        shared_aux = (shared_module._exec.aux_dict
                      if shared_module is not None
                      and shared_module._exec is not None else {})
        aux = [shared_aux[n] if n in shared_aux else nd.zeros(s, ctx=ctx)
               for n, s in zip(self._aux_names, aux_shapes)]

        from ..executor import Executor
        self._exec = Executor(self._symbol, ctx, args, grads, reqs, aux)
        self._execs = {}
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True

    # -- parameters ------------------------------------------------------
    def get_params(self):
        """``(arg_params, aux_params)``: the bound NDArrays themselves."""
        assert self.binded and self.params_initialized
        arg = {n: self._exec.arg_dict[n] for n in self._param_names}
        aux = dict(self._exec.aux_dict)
        return arg, aux

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        """Copy ``arg_params``/``aux_params`` (or those of ``Module.load``)
        into the bound arrays, onto their device and in their dtype; the
        rest come from ``initializer`` (with ``allow_missing``)."""
        assert self.binded, "call bind before init_params"
        if self.params_initialized and not force_init:
            return
        if arg_params is None and self._preloaded:
            arg_params, aux_params = self._preloaded
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = cache[name]
                if src is not arr:
                    # a copy: the optimizer updates the bound arrays in
                    # place, and the caller's arrays must not move with them
                    arr._data = src._data.to(device=arr._data.device,
                                             dtype=arr._data.dtype,
                                             copy=True)
            elif cache is not None and not allow_missing:
                raise MXNetError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        if arg_params is not None and not allow_extra:
            extra = set(arg_params) - set(self._param_names) \
                - set(self._data_names) - set(self._label_names)
            if extra:
                raise MXNetError(
                    "arg_params contains names not in the symbol: %r "
                    "(pass allow_extra=True to ignore)" % sorted(extra))
        self.params_initialized = True

    # -- optimizer -------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (by name, with ``param_idx2name``), and the store
        or the local updater as ``model._create_kvstore`` decides; the
        states of ``Module.load(load_optimizer_states=True)`` are read
        here."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        arg_dict = {n: self._exec.arg_dict[n] for n in self._param_names}
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._contexts), arg_dict)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **dict(optimizer_params))
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv is not None:
            if update_on_kvstore:
                kv.set_optimizer(optimizer)
            _initialize_kvstore(
                kvstore=kv,
                param_arrays=[arg_dict[n] for n in self._param_names],
                arg_params=arg_dict, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._states_fname:
            self.load_optimizer_states(self._states_fname)
            self._states_fname = None

    # -- computation -----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Copy the batch into the bound inputs and run the Executor; a
        batch of other shapes first re-binds through ``Executor.reshape``
        (parameters keep their arrays), or takes the executor that an
        earlier batch of its shapes bound, with its captured graphs."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        new_shapes = {n: tuple(a.shape) for n, a in feeds.items()}
        cur_shapes = {n: tuple(self._exec.arg_dict[n].shape)
                      for n in feeds}
        if new_shapes != cur_shapes:
            self._execs[tuple(sorted(cur_shapes.items()))] = self._exec
            self._exec = self._execs.get(tuple(sorted(new_shapes.items()))) \
                or self._exec.reshape(allow_up_sizing=True, **new_shapes)
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter with a gradient."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        params = [self._exec.arg_dict[n] for n in self._param_names]
        grads = [self._exec.grad_dict[n] for n in self._param_names]
        if self._kvstore is not None and self._update_on_kvstore:
            _update_params_on_kvstore(params, grads, self._kvstore,
                                      self._param_names)
        else:
            _update_params(params, grads, updater=self._updater,
                           num_device=len(self._contexts),
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if isinstance(labels, dict):
            labels_ = labels
        else:
            labels_ = dict(zip(self._label_names, labels or []))
        preds = dict(zip(self.output_names, self._exec.outputs))
        eval_metric.update_dict(labels_, preds)

    def install_monitor(self, mon):
        """Raises: ``monitor.py`` is not ported (ROADMAP.md, queue 1,
        item 8)."""
        raise MXNetError("Module.install_monitor needs monitor.py, which "
                         "is not ported (ROADMAP.md, queue 1, item 8)")

    # -- checkpointing ---------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol; its parameters are applied
        at the first ``init_params`` after ``bind`` (and the optimizer
        states at ``init_optimizer``)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(symbol=symbol, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        mod._states_fname = "%s-%04d.states" % (prefix, epoch) \
            if load_optimizer_states else None
        return mod

    def save_optimizer_states(self, fname):
        """The updater's states (or the store's), written atomically."""
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
        else:
            from ..ndarray.utils import atomic_file
            with atomic_file(fname) as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as fin:
                self._updater.set_states(fin.read())
