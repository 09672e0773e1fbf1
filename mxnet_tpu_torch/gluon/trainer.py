"""Gluon Trainer (counterpart of mxnet_tpu/gluon/trainer.py).

The JAX package's constructor (``kvstore``, ``compression_params``,
``update_on_kvstore``) and methods: ``step(batch_size,
ignore_stale_grad)`` rescales gradients by 1 / batch_size and applies the
optimizer to every parameter whose ``grad_req`` is not "null";
``allreduce_grads`` + ``update`` split the same; ``save_states`` /
``load_states`` write and read the ``Updater.get_states`` bytes, which
the JAX package's files are too. The port keeps a parameter on one
device, so there is nothing to reduce: like the reference without a
kvstore (``model._create_kvstore`` gives none for one device),
``allreduce_grads`` does nothing. Parameters on several contexts, and
the kvstore over them, are ROADMAP queue 1 item 9 and raise.
"""
from __future__ import annotations

from ..base import MXNetError, atomic_write
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
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
        if compression_params:
            raise MXNetError("gradient compression needs a kvstore over "
                             "several contexts (ROADMAP queue 1 item 9)")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore needs a kvstore over "
                             "several contexts (ROADMAP queue 1 item 9)")
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
        if contexts is not None and len(contexts) > 1:
            raise MXNetError("a Trainer over several contexts (and its "
                             "kvstore) is not ported yet (ROADMAP queue 1 "
                             "item 9)")
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

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1 / batch_size, all-reduce (nothing on one device),
        update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after ``allreduce_grads``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            self._updater(i, param.grad(), param.data())

    def save_states(self, fname):
        """The updater's states and optimizer, pickled (the bytes the JAX
        package's ``save_states`` writes)."""
        atomic_write(fname, self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """States written by ``save_states`` of either package."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = {i: param for i, param in
                                      enumerate(self._params)}
