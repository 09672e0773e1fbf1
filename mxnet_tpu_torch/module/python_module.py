"""PythonModule / PythonLossModule: modules written in Python
(counterpart of mxnet_tpu/module/python_module.py; the reference's
python/mxnet/module/python_module.py). A PythonModule has no parameters
by default; a subclass overrides forward/backward to put any Python
computation (a loss, a sampler, a metrics-only head) in a
SequentialModule chain or a fit loop.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .base_module import BaseModule


class PythonModule(BaseModule):
    """Subclass and override forward/backward (+ _compute_output_shapes if
    output shapes differ from the defaults)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names or []
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- params: none by default --------------------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert len(data_shapes) == len(self._data_names)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        if label_shapes is not None:
            assert self._label_names is not None
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Default: outputs mirror the data shapes."""
        return [(name, d[1])
                for name, d in zip(self._output_names, self._data_shapes)]

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss head in python: forward stores data, backward produces the
    gradient via a user function (python_module.py PythonLossModule)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(list(data_names), list(label_names),
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            from ..ndarray.ndarray import NDArray
            if not isinstance(grad, NDArray):
                from ..ndarray.ndarray import array
                # on the scores' context (the port's default is the card)
                grad = array(np.asarray(grad), ctx=self._scores.context)
            self._scores_grad = grad
        else:
            raise MXNetError("PythonLossModule requires grad_func")

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
