"""Optimizers (counterpart of mxnet_tpu/optimizer.py): the ``Optimizer``
base (rescale_grad, clip_gradient, learning-rate schedulers,
``begin_num_update``, per-index update counts, lr/wd multipliers from a
symbol's ``__lr_mult__`` / ``__wd_mult__`` attrs, from ``param_idx2name``
or from Gluon parameters, ``register`` / ``create``), ``SGD``, ``Adam``
and the ``Updater`` with ``get_states`` / ``set_states``.

Two callers: Module's updater hands NDArrays, Gluon's ``Trainer`` hands
tensors. Both go through the registered update ops
(``ops/optimizer_ops.py``: ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_*``, ``adam_update``), whose results are copied into the weight
and its states in place. The ops follow MXNet's rules, which differ from
``torch.optim``:

* SGD: g = clip(rescale_grad * grad) + wd * w (decay after clipping);
  with momentum, m = momentum * m - lr * g and w += m.
* Adam: g = clip(rescale_grad * grad + wd * w) (decay before clipping);
  m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
  w -= lr_t * m / (sqrt(v) + eps) with the bias correction folded into
  the step size, lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), and eps added
  to sqrt(v) uncorrected.
* A gradient is clipped only when clip_gradient > 0.
* Without per-parameter multipliers, only ``*_weight`` and ``*_gamma``
  parameters decay (``set_wd_mult``'s rule).
"""
from __future__ import annotations

import io
import logging
import math
import pickle

import torch

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "register",
           "create"]


def _is_nd(x):
    from .ndarray.ndarray import NDArray
    return isinstance(x, NDArray)


def _half(dtype):
    return dtype in (torch.float16, torch.bfloat16)


class Optimizer:
    """Base optimizer. Tracks per-index update counts (schedulers, Adam's
    t) and resolves lr/wd multipliers for each index."""

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

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """Half-precision weights get a float32 master copy under
        ``multi_precision``."""
        if self.multi_precision and _half(_tensor_of(weight).dtype):
            master = _master(weight)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _half(_tensor_of(weight).dtype):
            master, inner = state
            self.update(index, master, _tensor_of(grad).to(torch.float32),
                        inner)
            with torch.no_grad():
                _tensor_of(weight).copy_(_tensor_of(master))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined. Note that set_learning_rate can "
                              "mutate the value of the learning rate of the "
                              "optimizer only when the LRScheduler of the "
                              "optimizer is undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # biases and norm shifts are not weight-decayed by default
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _apply(self, op, weight, grad, states, **attrs):
        """Run the registered update op ``op`` on the tensors of the
        weight, gradient and states (NDArrays or Gluon's tensors alike)
        and copy its results into the weight and the states in place."""
        from .ops.registry import OpCtx, get_op
        schema = get_op(op)
        attrs["rescale_grad"] = self.rescale_grad
        if self.clip_gradient is not None:
            attrs["clip_gradient"] = self.clip_gradient
        dsts = [_tensor_of(x) for x in (weight, *states)]
        outs = schema.fcompute(schema.parse_attrs(attrs), OpCtx(), dsts[0],
                               _tensor_of(grad), *dsts[1:])
        with torch.no_grad():
            for dst, new in zip(dsts, outs):
                dst.copy_(new)


def _tensor_of(x):
    return x._data if _is_nd(x) else x


def _master(weight):
    """A float32 copy of a half-precision weight."""
    if _is_nd(weight):
        return weight.astype("float32")
    return weight.detach().to(torch.float32)


def _zeros_like(weight):
    if _is_nd(weight):
        from .ndarray.ndarray import NDArray
        return NDArray(torch.zeros_like(weight._data))
    return torch.zeros_like(weight)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum (NDArrays: the fused sgd ops, float32
    masters for half weights under ``multi_precision``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _half(_tensor_of(weight).dtype):
            master = _master(weight)
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        if state is not None:
            self._apply("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum)
        else:
            self._apply("sgd_update", weight, grad, (), lr=lr, wd=wd)

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and _half(_tensor_of(weight).dtype)):
            return self.update(index, weight, grad, state)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        mom, master = state
        if mom is not None:
            self._apply("mp_sgd_mom_update", weight, grad, (mom, master),
                        lr=lr, wd=wd, momentum=self.momentum)
        else:
            self._apply("mp_sgd_update", weight, grad, (master,), lr=lr,
                        wd=wd)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size (see the
    module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        self._apply("adam_update", weight, grad, state, lr=lr, wd=wd,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)


class Updater:
    """Applies an optimizer to (index, grad, weight), creating each
    index's state on first use; ``get_states`` / ``set_states`` pickle
    the states (NDArrays through the host)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(
                self.states[index], weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, weight):
        """A loaded state moved to its weight's device."""
        if _is_nd(state):
            return state.as_in_context(weight.context) if _is_nd(weight) \
                else state
        if isinstance(state, torch.Tensor):
            return state.to(_tensor_of(weight).device)
        if isinstance(state, (tuple, list)):
            synced = (self.sync_state_context(s, weight) for s in state)
            return tuple(synced) if isinstance(state, tuple) \
                else list(synced)
        return state

    def set_states(self, states):
        """Load ``get_states`` bytes of this package or of the JAX
        package (its NDArrays rebuilt as the port's)."""
        states = _StateUnpickler(io.BytesIO(states)).load()
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


class _StateUnpickler(pickle.Unpickler):
    """Optimizer states pickled by either package: the JAX package's
    names (``mxnet_tpu.ndarray.ndarray._from_numpy_reduce``) resolve to
    the port's module of the same name, so nothing of that package is
    imported."""

    def find_class(self, module, name):
        if module == "mxnet_tpu" or module.startswith("mxnet_tpu."):
            module = "mxnet_tpu_torch" + module[len("mxnet_tpu"):]
        return super().find_class(module, name)


def get_updater(optimizer):
    return Updater(optimizer)
