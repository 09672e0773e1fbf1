"""Optimizer update operators (counterpart of
mxnet_tpu/ops/optimizer_ops.py): ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update`` and ``ftml_update``, with the
reference's order of rescale, clip and weight decay. ``lr`` (and FTML's
step count ``t``) may be a device tensor instead of a number:
``DataParallelTrainer`` passes its own, so a captured step reads them.

Calling convention (MXNet's): ``mx.nd.sgd_mom_update(w, g, mom, out=w,
lr=...)``. The state inputs are aux with ``aux_always=True``, so their
updated values are written back into the NDArrays passed; the new weight
is output 0, written into ``w`` through ``out=``. The updates run under
``torch.no_grad()`` (the imperative layer's write-backs are copies into
the bound tensors, so an update makes no second copy of a weight). The
optimizers (``optimizer.py``) call these fcompute functions on the
tensors of Module's NDArrays and of Gluon's parameters alike, and copy
the results in place.
"""
from __future__ import annotations

import functools

import torch

from .registry import Param, register

__all__ = []


def _clip(attrs, g):
    c = attrs.clip_gradient
    return g.clamp(-c, c) if c is not None and c > 0 else g


def _prep(attrs, grad, weight):
    """rescale -> clip -> + wd * weight (the SGD family: the reference
    clips the rescaled gradient, then adds the decay)."""
    return _clip(attrs, grad * attrs.rescale_grad) + attrs.wd * weight


def _prep_wd_first(attrs, grad, weight):
    """rescale -> + wd * weight -> clip (Adam, RMSProp, FTML: the decay
    is folded into the gradient before clipping)."""
    return _clip(attrs, grad * attrs.rescale_grad + attrs.wd * weight)


@functools.lru_cache(maxsize=None)
def _one_minus_in(b, dtype):
    one = torch.ones((), dtype=dtype)
    return float(one - torch.tensor(b, dtype=dtype))


def _one_minus(b, state):
    """1 - b as the JAX ops compute it: b cast to the state's type, then
    the difference in that type (in float32, 1 - 0.999 is 1.3e-5 off
    1 - float32(0.999) in relative terms, which Adam's second moment
    would carry)."""
    return _one_minus_in(float(b), state.dtype)


_COMMON = {
    "lr": Param("float", required=True),
    "wd": Param("float", 0.0),
    "rescale_grad": Param("float", 1.0),
    "clip_gradient": Param("float", -1.0),
}


def _p(**extra):
    d = dict(_COMMON)
    for k, v in extra.items():
        d[k] = Param("float", v)
    return d


def _lazy(attrs, grad, new, old):
    """The reference's lazy_update (optimizer_op.cc sparse sgd/adam
    kernels): with ``lazy_update`` only the rows a row_sparse gradient
    touches move; the others skip the decay, the momentum and the
    moments. Dense-backed, a row is touched when any of its values is
    nonzero (the JAX ops' ``_row_mask``: an explicitly listed all-zero
    row counts as untouched here; the optimizers' scatter path, which
    has the row list, does not). The optimizers set the attr only for a
    row_sparse gradient."""
    if not attrs.get("lazy_update"):
        return new
    axes = tuple(range(1, grad.ndim))
    touched = (grad != 0).any(dim=axes) if axes else grad != 0
    m = touched.reshape((-1,) + (1,) * (grad.ndim - 1))
    return tuple(torch.where(m, n, o) for n, o in zip(new, old))


@torch.no_grad()
def _sgd_update(attrs, octx, weight, grad):
    new_w = weight - attrs.lr * _prep(attrs, grad, weight)
    return _lazy(attrs, grad, (new_w,), (weight,))


@torch.no_grad()
def _sgd_mom_update(attrs, octx, weight, grad, mom):
    new_mom = attrs.momentum * mom - attrs.lr * _prep(attrs, grad, weight)
    return _lazy(attrs, grad, (weight + new_mom, new_mom), (weight, mom))


@torch.no_grad()
def _mp_sgd_update(attrs, octx, weight, grad, weight32):
    g32 = _prep(attrs, grad.to(torch.float32), weight32)
    new_w32 = weight32 - attrs.lr * g32
    return (new_w32.to(weight.dtype), new_w32)


@torch.no_grad()
def _mp_sgd_mom_update(attrs, octx, weight, grad, mom, weight32):
    g32 = _prep(attrs, grad.to(torch.float32), weight32)
    new_mom = attrs.momentum * mom - attrs.lr * g32
    new_w32 = weight32 + new_mom
    return (new_w32.to(weight.dtype), new_mom, new_w32)


@torch.no_grad()
def _adam_update(attrs, octx, weight, grad, mean, var):
    g = _prep_wd_first(attrs, grad, weight)
    b1, b2 = attrs.beta1, attrs.beta2
    new_mean = b1 * mean + _one_minus(b1, mean) * g
    new_var = b2 * var + _one_minus(b2, var) * torch.square(g)
    step = attrs.lr * new_mean / (torch.sqrt(new_var) + attrs.epsilon)
    return _lazy(attrs, grad, (weight - step, new_mean, new_var),
                 (weight, mean, var))


@torch.no_grad()
def _rmsprop_update(attrs, octx, weight, grad, n):
    g = _prep_wd_first(attrs, grad, weight)
    g1 = attrs.gamma1
    new_n = _one_minus(g1, n) * torch.square(g) + g1 * n
    new_w = weight - attrs.lr * g / torch.sqrt(new_n + attrs.epsilon)
    return (_clip_weights(attrs, new_w), new_n)


@torch.no_grad()
def _rmspropalex_update(attrs, octx, weight, grad, n, g_avg, delta):
    g = _prep_wd_first(attrs, grad, weight)
    g1, g2 = attrs.gamma1, attrs.gamma2
    new_n = _one_minus(g1, n) * torch.square(g) + g1 * n
    new_g = _one_minus(g1, n) * g + g1 * g_avg
    new_delta = g2 * delta - attrs.lr * g / torch.sqrt(
        new_n - torch.square(new_g) + attrs.epsilon)
    return (_clip_weights(attrs, weight + new_delta), new_n, new_g,
            new_delta)


def _clip_weights(attrs, w):
    c = attrs.clip_weights
    return w.clamp(-c, c) if c is not None and c > 0 else w


@torch.no_grad()
def _ftrl_update(attrs, octx, weight, grad, z, n):
    g = _clip(attrs, grad * attrs.rescale_grad)
    lr = attrs.lr
    new_z = z + g - (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) \
        / lr * weight
    new_n = n + torch.square(g)
    l1 = attrs.lamda1
    new_w = torch.where(
        new_z.abs() > l1,
        (torch.sign(new_z) * l1 - new_z)
        / ((attrs.beta + torch.sqrt(new_n)) / lr + attrs.wd),
        torch.zeros_like(weight))
    return (new_w, new_z, new_n)


@torch.no_grad()
def _signsgd_update(attrs, octx, weight, grad):
    g = _clip(attrs, grad * attrs.rescale_grad)
    lr = attrs.lr
    return ((1 - lr * attrs.wd) * weight - lr * torch.sign(g),)


@torch.no_grad()
def _signum_update(attrs, octx, weight, grad, mom):
    g = _clip(attrs, grad * attrs.rescale_grad)
    m = attrs.momentum
    new_mom = m * mom - _one_minus(m, mom) * (g + attrs.wd * weight)
    lr = attrs.lr
    return ((1 - lr * attrs.wd_lh) * weight + lr * torch.sign(new_mom),
            new_mom)


@torch.no_grad()
def _ftml_update(attrs, octx, weight, grad, d, v, z):
    g = _prep_wd_first(attrs, grad, weight)
    t = attrs.t
    b1, b2, eps = attrs.beta1, attrs.beta2, attrs.epsilon
    new_v = b2 * v + _one_minus(b2, v) * torch.square(g)
    corr2 = 1 - b2 ** t
    corr1 = 1 - b1 ** t
    d_t = corr1 / attrs.lr * (torch.sqrt(new_v / corr2) + eps)
    sigma = d_t - b1 * d
    new_z = b1 * z + _one_minus(b1, v) * g - sigma * weight
    return (-new_z / d_t, d_t, new_v, new_z)


register("sgd_update", _sgd_update,
         params=dict(_p(), lazy_update=Param("bool", False)),
         inputs=("weight", "grad"))
register("sgd_mom_update", _sgd_mom_update,
         params=dict(_p(momentum=0.0), lazy_update=Param("bool", False)),
         inputs=("weight", "grad", "mom"), aux=("mom",),
         mutates_aux=True, aux_always=True)
register("mp_sgd_update", _mp_sgd_update, params=_p(),
         inputs=("weight", "grad", "weight32"), aux=("weight32",),
         mutates_aux=True, aux_always=True)
register("mp_sgd_mom_update", _mp_sgd_mom_update, params=_p(momentum=0.0),
         inputs=("weight", "grad", "mom", "weight32"),
         aux=("mom", "weight32"), mutates_aux=True, aux_always=True)
register("adam_update", _adam_update,
         params=dict(_p(beta1=0.9, beta2=0.999, epsilon=1e-8),
                     lazy_update=Param("bool", False)),
         inputs=("weight", "grad", "mean", "var"), aux=("mean", "var"),
         mutates_aux=True, aux_always=True)
register("rmsprop_update", _rmsprop_update,
         params=_p(gamma1=0.95, epsilon=1e-8, clip_weights=-1.0),
         inputs=("weight", "grad", "n"), aux=("n",),
         mutates_aux=True, aux_always=True)
register("rmspropalex_update", _rmspropalex_update,
         params=_p(gamma1=0.95, gamma2=0.9, epsilon=1e-8, clip_weights=-1.0),
         inputs=("weight", "grad", "n", "g", "delta"),
         aux=("n", "g", "delta"), mutates_aux=True, aux_always=True)
register("ftrl_update", _ftrl_update, params=_p(lamda1=0.01, beta=1.0),
         inputs=("weight", "grad", "z", "n"), aux=("z", "n"),
         mutates_aux=True, aux_always=True)
register("signsgd_update", _signsgd_update, params=_p(),
         inputs=("weight", "grad"))
register("signum_update", _signum_update, params=_p(momentum=0.0, wd_lh=0.0),
         inputs=("weight", "grad", "mom"), aux=("mom",),
         mutates_aux=True, aux_always=True)
register("ftml_update", _ftml_update,
         params={**_p(beta1=0.6, beta2=0.999, epsilon=1e-8),
                 "t": Param("int", required=True)},
         inputs=("weight", "grad", "d", "v", "z"), aux=("d", "v", "z"),
         mutates_aux=True, aux_always=True)
