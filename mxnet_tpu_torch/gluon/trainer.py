"""Gluon Trainer on one device: applies an Optimizer to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` for one device: ``step``
(rescale the gradients by ``rescale_grad / batch_size``, then update),
``update``, ``allreduce_grads`` (nothing to reduce on one device),
``learning_rate``/``set_learning_rate`` and ``save_states``/
``load_states``, whose files the JAX package's Trainer reads and writes
too.  Where the JAX package fuses every parameter's update into one
jitted program (``_FusedUpdate``), the optimizer here updates all
parameters in one pass of ``torch._foreach_*`` operations.  The kvstore,
the ZeRO-sharded update and gradient compression wait for the
data-parallel port.

As in MXNet, ``step`` refuses a parameter whose gradient no ``backward``
has written since the last update (a stale gradient), unless
``ignore_stale_grad=True``, which skips such parameters.
"""
from __future__ import annotations

import os
import tempfile

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Optimizer driver over ``params`` (a ParameterDict, a dict or a list
    of Parameters; a dict is taken in sorted key order, as in the JAX
    package, so state indices agree between the two)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params)))
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
        if kvstore not in ("device", "local", None) or compression_params:
            raise MXNetError("kvstore %r and gradient compression are not "
                             "ported: they come with the data-parallel "
                             "trainer" % (kvstore,))
        self._params = list(params)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Nothing to reduce: one device holds every gradient."""

    def step(self, batch_size, ignore_stale_grad=False):
        """One update from the gradients of the last ``backward``, each
        scaled by ``rescale_grad / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """As :meth:`step` (there is no reduction to leave out)."""
        self.step(batch_size, ignore_stale_grad)

    def _update(self, ignore_stale_grad):
        indices, grads, weights = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            data = param.data()
            if not data._fresh_grad:
                if ignore_stale_grad:
                    continue
                raise UserWarning(
                    "Gradient of Parameter `%s` has not been updated by "
                    "backward since last `step`. This could mean a bug in "
                    "your model that made it only use a subset of the "
                    "Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning and "
                    "skip updating of Parameters with stale gradient"
                    % param.name)
            indices.append(i)
            grads.append(param.grad())
            weights.append(data)
        if indices:
            self._updater._trainer_update(indices, grads, weights)
        for w in weights:
            w._fresh_grad = False

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname`` atomically (a
        temporary file, then ``os.replace``)."""
        payload = self._updater.get_states(dump_optimizer=True)
        directory = os.path.dirname(os.path.abspath(fname))
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-states-")
        try:
            with os.fdopen(fd, "wb") as fout:
                fout.write(payload)
            os.replace(tmp, fname)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def load_states(self, fname):
        """Read a :meth:`save_states` file of either package."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
