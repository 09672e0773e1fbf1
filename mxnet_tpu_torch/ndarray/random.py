"""``mx.nd.random`` (counterpart of mxnet_tpu/ndarray/random.py): draws
from the port's explicit ``torch.Generator`` of the target device
(``mxnet_tpu_torch.random.generator``), which ``mx.random.seed`` seeds.
The numbers differ from the JAX package's for one seed (another
generator); tests hand both packages the same numpy draws instead."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .. import random as _random
from .ndarray import NDArray, _device, _shape

__all__ = ["uniform", "normal", "randint"]


def _target(shape, dtype, ctx, out):
    if out is not None:
        return out, out._data
    t = torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                    device=_device(ctx))
    return NDArray(t), t


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None, **kw):
    res, t = _target(shape, dtype, ctx, out)
    with torch.no_grad():
        t.uniform_(float(low), float(high),
                   generator=_random.generator(t.device))
    return res


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None, **kw):
    res, t = _target(shape, dtype, ctx, out)
    with torch.no_grad():
        t.normal_(float(loc), float(scale),
                  generator=_random.generator(t.device))
    return res


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None, **kw):
    res, t = _target(shape, dtype, ctx, out)
    with torch.no_grad():
        t.random_(int(low), int(high),
                  generator=_random.generator(t.device))
    return res
