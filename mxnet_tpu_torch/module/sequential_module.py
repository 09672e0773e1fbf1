"""SequentialModule: a chain of modules run back to back (counterpart of
mxnet_tpu/module/sequential_module.py; the reference's
python/mxnet/module/sequential_module.py). Each sub-module's outputs are
the next one's data; labels go to the modules added with
``take_labels=True``; gradients flow back through ``get_input_grads``.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append a sub-module. kwargs: take_labels, auto_wiring."""
        self._modules.append(module)
        for k in kwargs:
            if k not in self._meta_keys:
                raise MXNetError(f"Unknown meta {k!r}; accepted: "
                                 f"{sorted(self._meta_keys)}")
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

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

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)

        # parameter names must not collide across sub-modules
        seen = {}
        for i, mod in enumerate(self._modules):
            arg, aux = mod.get_params()
            for name in list(arg) + list(aux):
                if name in seen:
                    raise MXNetError(
                        f"duplicate parameter {name!r} in modules "
                        f"{seen[name]} and {i}")
                seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("SequentialModule does not support "
                             "shared_module")
        assert self._modules, "add modules first before binding"
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_data = data_shapes
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            if meta.get(self.META_TAKE_LABELS):
                my_label = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label = None
            # intermediate modules must pass input grads back
            need_grad = inputs_need_grad if i == 0 else for_training
            module.bind(data_shapes=my_data, label_shapes=my_label,
                        for_training=for_training,
                        inputs_need_grad=need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            # next module consumes this one's outputs, renamed to its own
            # data names (auto-wiring, sequential_module.py META_AUTO_WIRING)
            if i < len(self._modules) - 1:
                nxt = self._modules[i + 1]
                out_shapes = module.output_shapes
                if len(nxt.data_names) != len(out_shapes):
                    raise MXNetError(
                        f"module {i} emits {len(out_shapes)} outputs but "
                        f"module {i + 1} expects {len(nxt.data_names)} "
                        "inputs")
                my_data = [(dn, s[1]) for dn, s in zip(nxt.data_names,
                                                       out_shapes)]

        if not anybody_ever_needs_label:
            self._label_shapes = None
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

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
