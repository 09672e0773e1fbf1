"""Optimizers (counterpart of mxnet_tpu/optimizer.py): the ``Optimizer``
base (rescale_grad, clip_gradient, learning-rate schedulers,
``begin_num_update``, per-index update counts, lr/wd multipliers from a
symbol's ``__lr_mult__`` / ``__wd_mult__`` attrs, from ``param_idx2name``
or from Gluon parameters, ``register`` / ``create``), the JAX package's
17 optimizers (SGD, Signum, SignSGD, FTML, DCASGD, NAG, SGLD, ccSGD,
Adam, AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam, LBSGD, Test) under
its registered names, and the ``Updater`` with ``get_states`` /
``set_states``.

Module, the kvstore and Gluon's ``Trainer`` hand the updater NDArrays;
plain tensors work too. SGD, Adam, RMSProp, Ftrl, Signum / SignSGD and
FTML go through the registered update ops (``ops/optimizer_ops.py``),
whose results are copied into the weight and its states in place; the
others update the weight's and states' tensors in place with the JAX
package's arithmetic, in its order. The ops follow MXNet's rules, which
differ from ``torch.optim``:

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
import types

import torch

from . import random as _random
from .ndarray.ndarray import NDArray
from .ops import sparse_ops as sp

__all__ = ["Optimizer", "SGD", "Signum", "SignSGD", "FTML", "DCASGD", "NAG",
           "SGLD", "ccSGD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "LBSGD", "Test", "Updater", "get_updater",
           "register", "create"]


def _is_nd(x):
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

    def __getstate__(self):
        # the Gluon parameters are the Trainer's, not state: it sets
        # param_dict again after loading (as the reference's optimizer)
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}

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


def _zeros_like(weight, dtype=None):
    """Zeros of the weight's shape on its device, as an NDArray when the
    weight is one; in the weight's dtype unless ``dtype`` says (the JAX
    package makes some optimizers' states float32 whatever the weight)."""
    z = torch.zeros_like(_tensor_of(weight), dtype=dtype)
    return NDArray(z) if _is_nd(weight) else z


def _copy_of(weight):
    t = _tensor_of(weight).detach().clone()
    return NDArray(t) if _is_nd(weight) else t


def _stype(x):
    return getattr(x, "stype", "default")


def _sparse_components(grad):
    """(values, row ids) of a row_sparse gradient built from its parts
    (ndarray/sparse.py), else None: the gate of the scatter path, whose
    work scales with the listed rows."""
    ell = getattr(grad, "_ell", None)
    if ell is None or len(ell) != 2:
        return None     # dense-backed, or a CSR's three ELL parts
    return ell


def _row_kwargs(opt):
    return {"rescale_grad": opt.rescale_grad,
            "clip_gradient": -1.0 if opt.clip_gradient is None
            else opt.clip_gradient}


def _write(dst, new):
    """Copy an update's result into the weight or state in place."""
    with torch.no_grad():
        _tensor_of(dst).copy_(new)


def _scaled_grad(opt, grad):
    """rescale_grad * grad, clipped to +-clip_gradient whenever it is set
    (the JAX package's arithmetic optimizers clip without the > 0 test
    of the update ops)."""
    g = _tensor_of(grad) * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g


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
        # lazy_update engages only for a row_sparse gradient (the
        # reference's optimizer.py:498): untouched rows skip the decay
        # and the momentum
        lazy = self.lazy_update and _stype(grad) == "row_sparse"
        parts = _sparse_components(grad) if lazy else None
        if parts is not None:
            # the scatter path: only the gradient's listed rows
            vals, rows = parts
            kw = _row_kwargs(self)
            if state is not None:
                new_w, new_m = sp.rows_sgd_mom_update(
                    _tensor_of(weight), _tensor_of(state), rows, vals, lr,
                    self.momentum, wd=wd, **kw)
                _write(state, new_m)
            else:
                new_w = sp.rows_sgd_update(_tensor_of(weight), rows, vals,
                                           lr, wd=wd, **kw)
            _write(weight, new_w)
            return
        if state is not None:
            self._apply("sgd_mom_update", weight, grad, (state,), lr=lr,
                        wd=wd, momentum=self.momentum, lazy_update=lazy)
        else:
            self._apply("sgd_update", weight, grad, (), lr=lr, wd=wd,
                        lazy_update=lazy)

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
        lazy = self.lazy_update and _stype(grad) == "row_sparse"
        parts = _sparse_components(grad) if lazy else None
        if parts is not None:
            vals, rows = parts
            mean, var = state
            new_w, new_m, new_v = sp.rows_adam_update(
                _tensor_of(weight), _tensor_of(mean), _tensor_of(var), rows,
                vals, lr, self.beta1, self.beta2, self.epsilon, wd=wd,
                **_row_kwargs(self))
            for dst, new in ((weight, new_w), (mean, new_m), (var, new_v)):
                _write(dst, new)
            return
        self._apply("adam_update", weight, grad, state, lr=lr, wd=wd,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    lazy_update=lazy)


@register
class Signum(Optimizer):
    """signum_update with momentum, signsgd_update without."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        if state is not None:
            kw = {"momentum": self.momentum} if self.momentum > 0 else {}
            self._apply("signum_update", weight, grad, (state,), lr=lr,
                        wd=wd, wd_lh=self.wd_lh, **kw)
        else:
            self._apply("signsgd_update", weight, grad, (), lr=lr, wd=wd)


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        self._apply("ftml_update", weight, grad, state, lr=lr, wd=wd,
                    beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon, t=t)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, _copy_of(weight))
        return (_zeros_like(weight), _copy_of(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = _scaled_grad(self, grad)
        w = _tensor_of(weight)
        mom, previous = state
        prev = _tensor_of(previous)
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
        if mom is not None:
            m = _tensor_of(mom)
            m.mul_(self.momentum).add_(delta)
            delta = m
        prev.copy_(w)
        w.add_(delta)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = _scaled_grad(self, grad)
        w = _tensor_of(weight)
        if state is not None:
            mom = _tensor_of(state)
            mom.mul_(self.momentum)
            g = g + wd * w
            mom.add_(g)
            g = g + self.momentum * mom
            w.add_(-lr * g)
        else:
            w.add_(-lr * (g + wd * w))


def _sgld_noise(weight, lr):
    """SGLD's N(0, lr) noise for a weight tensor, from the port's
    generator of its device."""
    return torch.empty_like(weight).normal_(
        0.0, math.sqrt(lr), generator=_random.generator(weight.device))


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = _scaled_grad(self, grad)
        w = _tensor_of(weight)
        w.add_(-lr / 2 * (g + wd * w) + _sgld_noise(w, lr))


@register
class ccSGD(SGD):
    """The reference's deprecated name of SGD."""


@register
class AdaGrad(Optimizer):
    """AdaGrad. A row_sparse gradient is used densely, its backing
    tensor over every row (as the JAX class does: its arithmetic on the
    gradient makes a dense array), so rows without gradient still take
    the weight decay."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight, torch.float32)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = _scaled_grad(self, grad)
        w = _tensor_of(weight)
        history = _tensor_of(state)
        history.add_(g * g)
        div = g / (history + self.float_stable_eps) ** 0.5
        w.add_((div + w * wd) * -lr)


@register
class RMSProp(Optimizer):
    """rmsprop_update, or rmspropalex_update when ``centered``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight, torch.float32) for _ in range(n))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        kw = {"gamma1": self.gamma1, "epsilon": self.epsilon}
        if self.centered:
            kw["gamma2"] = self.gamma2
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        op = "rmspropalex_update" if self.centered else "rmsprop_update"
        self._apply(op, weight, grad, state, lr=lr, wd=wd, **kw)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        g = _scaled_grad(self, grad)
        w = _tensor_of(weight)
        acc_g, acc_delta = (_tensor_of(s) for s in state)
        rho, eps = self.rho, self.epsilon
        acc_g.mul_(rho).add_((1. - rho) * g * g)
        delta = (acc_delta + eps).sqrt() / (acc_g + eps).sqrt() * g
        acc_delta.mul_(rho).add_((1. - rho) * delta * delta)
        w.sub_(delta + wd * w)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(**kwargs)
        self.lamda1 = lamda1
        self.beta = beta
        self.lr = learning_rate

    def create_state(self, index, weight):
        return (_zeros_like(weight, torch.float32),
                _zeros_like(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        lr = self._get_lr(index)
        self._apply("ftrl_update", weight, grad, state, lr=lr, wd=wd,
                    lamda1=self.lamda1, beta=self.beta)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        w = _tensor_of(weight)
        g = _tensor_of(grad) * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        m_t, u_t = (_tensor_of(s) for s in state)
        m_t.mul_(self.beta1).add_((1. - self.beta1) * g)
        u_t.copy_(torch.maximum(self.beta2 * u_t, g.abs()))
        w.sub_(lr * m_t / u_t)


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        w = _tensor_of(weight)
        g = _tensor_of(grad) * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        b1, b2 = self.beta1, self.beta2
        momentum_t = b1 * (1. - 0.5 * (pow(0.96, t * self.schedule_decay)))
        momentum_t_1 = b1 * (1. - 0.5 * (pow(0.96, (t + 1)
                                             * self.schedule_decay)))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = (_tensor_of(s) for s in state)
        m_t.mul_(b1).add_((1. - b1) * g)
        v_t.mul_(b2).add_((1. - b2) * g * g)
        grad_prime = g / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - pow(b2, t))
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        w.sub_(lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD: the JAX package's warm-up of a layer-wise lr
    multiplier (linear, power2 or sqrt up to batch_scale over
    warmup_epochs)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum, multi_precision=multi_precision,
                         **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def _get_lr(self, index):
        lr = super()._get_lr(index)
        self.lbmult = self._get_lbmult(self.num_update + self.init_updates)
        return lr * self.lbmult


@register
class Test(Optimizer):
    """The reference's test optimizer: w += rescale_grad * grad; the
    state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight, torch.float32)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        w = _tensor_of(weight)
        w.add_(_tensor_of(grad) * self.rescale_grad)
        _tensor_of(state).copy_(w)


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
        """The states (and the optimizer) pickled under the JAX package's
        names, so that its plain ``pickle.loads`` builds its own NDArrays
        and optimizer from them; ``set_states`` of either package reads
        them."""
        return _dump_states(self.states,
                            self.optimizer if dump_optimizer else None)


def _dump_states(states, optimizer=None):
    """(states, optimizer), or the states alone, pickled under the JAX
    package's names (the bytes of ``Updater.get_states``)."""
    buf = io.BytesIO()
    _StatePickler(buf).dump((states, optimizer) if optimizer is not None
                            else states)
    return buf.getvalue()


_PORT, _JAX = "mxnet_tpu_torch", "mxnet_tpu"


class _StatePickler(pickle._Pickler):
    """Pickles the port's globals (its NDArray reducer, optimizers, lr
    schedulers) under the JAX package's module of the same name, and a
    ``torch.Tensor`` (the states of a weight handed in as a tensor) as an
    NDArray; nothing of that package is imported. ``pickle`` checks that
    a global's name resolves to the object saved, so the override writes
    the name itself (the C pickler, and ``reducer_override``, cannot
    rename a global)."""

    dispatch = pickle._Pickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file, protocol=4)

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            from .ndarray.ndarray import _from_numpy_reduce
            return (_from_numpy_reduce, (NDArray(obj.detach()).asnumpy(),))
        return NotImplemented

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if module != _PORT and not module.startswith(_PORT + "."):
            return super().save_global(obj, name)
        self.save(_JAX + module[len(_PORT):])
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    # the inherited entry is the base class's function, not the override
    dispatch[types.FunctionType] = save_global


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
