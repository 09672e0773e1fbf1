"""Optimizer update operators (counterpart of
mxnet_tpu/ops/optimizer_ops.py): ``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update`` and ``adam_update``, with the
reference's order of rescale, clip and weight decay.

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
    """rescale -> + wd * weight -> clip (Adam: the decay is folded into
    the gradient before clipping)."""
    return _clip(attrs, grad * attrs.rescale_grad + attrs.wd * weight)


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


@torch.no_grad()
def _sgd_update(attrs, octx, weight, grad):
    return (weight - attrs.lr * _prep(attrs, grad, weight),)


@torch.no_grad()
def _sgd_mom_update(attrs, octx, weight, grad, mom):
    new_mom = attrs.momentum * mom - attrs.lr * _prep(attrs, grad, weight)
    return (weight + new_mom, new_mom)


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
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    step = attrs.lr * new_mean / (torch.sqrt(new_var) + attrs.epsilon)
    return (weight - step, new_mean, new_var)


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
