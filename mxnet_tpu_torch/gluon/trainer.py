"""Gluon Trainer (subset of mxnet_tpu/gluon/trainer.py).

``step(batch_size)`` rescales gradients by 1 / batch_size, all-reduces
them, and applies the optimizer to every parameter whose ``grad_req`` is
not "null". On one device there is nothing to reduce: like the reference
without a kvstore (``model.py:_create_kvstore`` gives none for one
device), ``allreduce_grads`` does nothing. Several devices and the
kvstore are not ported yet.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and \
                    [repr(c) for c in contexts] != [repr(c) for c in ctx]:
                raise MXNetError(
                    "All Parameters must be initialized on the same set of "
                    f"contexts, but Parameter {param.name} is initialized "
                    f"on {ctx} while previous Parameters are initialized "
                    f"on {contexts}.")
            contexts = ctx
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """Rescale by 1 / batch_size, all-reduce, update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def update(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            self._updater(i, param.grad(), param.data())
