"""Optimizers (subset of mxnet_tpu/optimizer.py): the ``Optimizer`` base
(rescale_grad, clip_gradient, lr/wd multipliers from the parameters,
per-index update counts, ``register``/``create``), ``SGD``,
``Adam`` and ``Updater``. Learning-rate schedulers, multi-precision
masters and lazy (row-sparse) updates are not ported yet.

The updates are plain tensor ops (the JAX package's fused update ops have
no Pallas kernel), applied in place to the parameter under
``torch.no_grad()`` so no second copy of the weights exists. MXNet's
rules, which differ from ``torch.optim``:

* SGD: g = clip(rescale_grad * grad) + wd * w (decay after clipping);
  with momentum, m = momentum * m - lr * g and w += m.
* Adam: g = clip(rescale_grad * grad + wd * w) (decay before clipping);
  m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
  w -= lr_t * m / (sqrt(v) + eps) with the bias correction folded into
  the step size, lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), and eps added
  to sqrt(v) uncorrected. ``torch.optim.Adam`` corrects m and v instead
  and adds eps to the corrected root, which differs whenever eps matters.
* A gradient is clipped only when clip_gradient > 0.
"""
from __future__ import annotations

import logging
import math

import torch

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "register",
           "create"]


class Optimizer:
    """Base optimizer. Tracks per-index update counts (Adam's t) and
    reads lr/wd multipliers from the parameters (``param_dict``, index ->
    Parameter, as the Trainer passes it)."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("New optimizer %s overriding existing", name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1., wd=0., clip_gradient=None,
                 learning_rate=0.01, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.num_update = 0
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict if param_dict else {}

    @property
    def learning_rate(self):
        return self.lr

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = 0
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        return wd

    def _clip(self, g):
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._clip(grad * self.rescale_grad) + wd * weight
        if state is not None:
            state.mul_(self.momentum).sub_(lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size (see the
    module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        mean, var = state
        g = self._clip(grad * self.rescale_grad + wd * weight)
        mean.mul_(self.beta1).add_(g, alpha=1. - self.beta1)
        var.mul_(self.beta2).addcmul_(g, g, value=1. - self.beta2)
        weight.sub_(lr * mean / (var.sqrt() + self.epsilon))


class Updater:
    """Applies an optimizer to (index, grad, weight), creating each
    index's state on first use."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
