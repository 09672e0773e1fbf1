"""Weight initializers (subset of mxnet_tpu/initializer.py).

Same registry, name-suffix dispatch (``*weight`` -> the initializer's
own rule, ``*bias``/``*beta`` -> 0, ``*gamma`` -> 1) and the
``__init__``-attr route by which a parameter's own initializer applies
wholesale, on ``torch.Tensor`` arrays filled in place. Random draws come
from an explicit ``torch.Generator``: the one given to the initializer,
else the port's default generator of the array's device
(:func:`mxnet_tpu_torch.random.generator`).
"""
from __future__ import annotations

import json
import math

import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Xavier", "One",
           "Zero", "register", "create"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """Name + attrs descriptor handed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name.lower() not in _INIT_REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _INIT_REGISTRY[name.lower()](**kwargs)


class Initializer:
    """Base initializer; dispatches on parameter-name conventions and
    honours a per-parameter ``__init__`` attr."""

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def _gen(self, arr):
        return self._generator if self._generator is not None \
            else _random.generator(arr.device)

    @torch.no_grad()
    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            inner = create(klass, **kwargs)
            inner._generator = self._generator
            inner._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta"):
            arr.fill_(0.0)
        elif desc.endswith("gamma"):
            arr.fill_(1.0)
        else:
            raise ValueError(
                f"Unknown initialization pattern for {desc}. Default "
                "initialization is limited to \"weight\", \"bias\", "
                "\"gamma\" (1.0), and \"beta\" (0.0).")

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(1.0)


@register
class Uniform(Initializer):
    """U(-scale, scale); the default of ``Block.initialize``."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.uniform_(-self.scale, self.scale, generator=self._gen(arr))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.normal_(0.0, self.sigma, generator=self._gen(arr))


@register
class Xavier(Initializer):
    """Glorot: scale = sqrt(magnitude / factor), factor the average (or
    in, or out) fan of the (out, in, *kernel) shape; uniform on
    [-scale, scale] or gaussian with std scale."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}. "
                "It requires at least 2D.")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=self._gen(arr))
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=self._gen(arr))
        else:
            raise ValueError("Unknown random type")


# registry aliases matching the reference's names
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
