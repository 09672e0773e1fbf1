"""Weight initializers (counterpart of mxnet_tpu/initializer.py).

Same registry, ``InitDesc`` (name + attrs + ``global_init``), the
``__init__``-attr route by which a parameter's own initializer applies
wholesale, and the JAX package's name rules: ``*weight`` -> the
initializer's own rule, ``*bias`` / ``*beta`` / ``*min`` -> 0,
``*gamma`` / ``*max`` -> 1, ``*moving_mean`` / ``*moving_avg`` /
``*moving_inv_var`` -> 0, ``*moving_var`` -> 1; a plain string name
(not an InitDesc) takes the legacy rules (``upsampling*`` bilinear,
``stn_loc*``). Arrays are filled in place: a ``torch.Tensor`` (Gluon's
parameters) or an NDArray (``Module.init_params``). Random draws come
from an explicit ``torch.Generator``: the one given to the initializer,
else the port's default generator of the array's device
(:func:`mxnet_tpu_torch.random.generator`).
"""
from __future__ import annotations

import json
import logging
import math
import re

import numpy as np
import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Xavier",
           "MSRAPrelu", "One", "Zero", "Constant", "Orthogonal", "Bilinear",
           "LSTMBias", "FusedRNN", "Mixed", "Load", "register", "create"]

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


def _tensor(arr):
    """The tensor an initializer fills: a tensor itself, or an NDArray's."""
    return arr if isinstance(arr, torch.Tensor) else arr._data


class Initializer:
    """Base initializer; dispatches on parameter-name conventions and
    honours a per-parameter ``__init__`` attr."""

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def _gen(self, t):
        return self._generator if self._generator is not None \
            else _random.generator(t.device)

    @torch.no_grad()
    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            self._legacy_init(desc, arr)
            return
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            # a dumps() string, or a registered name (a Gluon parameter's
            # string initializer, carried by Parameter.var())
            klass, kwargs = json.loads(init) if init.lstrip().startswith(
                "[") else (init, {})
            inner = create(klass, **kwargs)
            inner._generator = self._generator
            inner._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias") or desc.endswith("beta") \
                or desc.endswith("min"):
            self._set(arr, 0.0)
        elif desc.endswith("gamma") or desc.endswith("max"):
            self._set(arr, 1.0)
        elif desc.endswith("moving_mean") or desc.endswith("moving_avg") \
                or desc.endswith("moving_inv_var"):
            self._set(arr, 0.0)
        elif desc.endswith("moving_var"):
            self._set(arr, 1.0)
        else:
            self._init_default(desc, arr)

    def _legacy_init(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be string")
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.startswith("stn_loc") and name.endswith("weight"):
            self._set(arr, 0.0)
        elif name.startswith("stn_loc") and name.endswith("bias"):
            _tensor(arr).copy_(torch.tensor([1.0, 0, 0, 0, 1.0, 0]))
        elif name.endswith("bias") or name.endswith("beta"):
            self._set(arr, 0.0)
        elif name.endswith("gamma"):
            self._set(arr, 1.0)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean") or name.endswith("moving_inv_var") \
                or name.endswith("moving_avg"):
            self._set(arr, 0.0)
        elif name.endswith("moving_var"):
            self._set(arr, 1.0)
        else:
            self._init_default(name, arr)

    @staticmethod
    def _set(arr, value):
        _tensor(arr).fill_(value)

    def _init_bilinear(self, _, arr):
        t = _tensor(arr)
        shape = t.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        i = np.arange(int(np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        t.copy_(torch.from_numpy(w.astype(np.float32).reshape(shape)))

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, _):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default "
            "initialization is limited to \"weight\", \"bias\", "
            "\"gamma\" (1.0), and \"beta\" (0.0). Please use "
            "mx.sym.Variable(init=mx.init.*) to set initialization pattern")


@register
class Load:
    """Initialize from a param dict or file, falling back to
    ``default_init``; ``arg:`` / ``aux:`` prefixes are dropped."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray.ndarray import load as nd_load
            param = nd_load(param)
        self.param = {}
        for name, arr in param.items():
            if name.startswith("arg:") or name.startswith("aux:"):
                name = name[4:]
            self.param[name] = arr
        self.default_init = default_init
        self.verbose = verbose

    @torch.no_grad()
    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src = src if isinstance(src, torch.Tensor) else \
                getattr(src, "_data", None)
            if src is None:
                src = torch.from_numpy(np.asarray(self.param[name]))
            dst = _tensor(arr)
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {tuple(dst.shape)} vs loaded "
                    f"{tuple(src.shape)}")
            dst.copy_(src)
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    f"Cannot Initialize {name}. Not found in loaded param "
                    "and no default initializer is provided.")
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """Pattern-matched initializer list: the first regex that matches a
    parameter's name picks its initializer."""

    def __init__(self, patterns, initializers):
        assert len(patterns) == len(initializers)
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            f"Parameter name {name} did not match any pattern. Consider "
            "adding a \".*\" pattern at the and with default Initializer.")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale); the default of ``Block.initialize``."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        t = _tensor(arr)
        t.uniform_(-self.scale, self.scale, generator=self._gen(t))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        t = _tensor(arr)
        t.normal_(0.0, self.sigma, generator=self._gen(t))


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
        t = _tensor(arr)
        shape = t.shape
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
            t.uniform_(-scale, scale, generator=self._gen(t))
        elif self.rnd_type == "gaussian":
            t.normal_(0.0, scale, generator=self._gen(t))
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He et al.: gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2. / (1 + slope ** 2),
                         generator=generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """Saxe et al. (arXiv:1312.6120): the SVD of a random (n_out, fan_in)
    matrix, uniform in [-1, 1] or standard normal, drawn from the
    generator; whichever factor has that shape, times ``scale``, is the
    weight. The SVD runs in float64."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        t = _tensor(arr)
        flat = (t.shape[0], math.prod(t.shape[1:]))
        seed = torch.empty(flat, dtype=torch.float64, device=t.device)
        if self.rand_type == "uniform":
            seed.uniform_(-1.0, 1.0, generator=self._gen(t))
        elif self.rand_type == "normal":
            seed.normal_(0.0, 1.0, generator=self._gen(t))
        else:
            raise ValueError(f"unknown rand_type {self.rand_type!r}")
        u, _sv, vt = torch.linalg.svd(seed, full_matrices=False)
        basis = u if tuple(u.shape) == flat else vt
        t.copy_((self.scale * basis).reshape(t.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (the ``upsampling*`` legacy rule)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@register
class LSTMBias(Initializer):
    """Zero bias except the forget gate's quarter (``forget_bias``)."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        t = _tensor(arr)
        h = t.shape[0] // 4
        t.zero_()
        t[h:2 * h] = self.forget_bias


class FusedRNN(Initializer):
    """A fused RNN op's flat parameter blob filled by an inner initializer
    as one weight (the JAX package's rule: its biases are not set apart)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0, generator=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _INIT_REGISTRY[klass.lower()](**kwargs)
        super().__init__(generator,
                         init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init

    def _init_weight(self, desc, arr):
        if self._init is not None:
            if self._init._generator is None:
                self._init._generator = self._generator
            self._init._init_weight(desc, arr)


# registry aliases matching the reference's names
_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
