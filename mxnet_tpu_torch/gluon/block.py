"""Gluon Block / HybridBlock as ``torch.nn.Module`` subclasses (subset of
mxnet_tpu/gluon/block.py).

Children live in ``nn.Module``'s own registry: a block assigned to an
attribute is registered under that name, and ``register_child`` adds one
under the next index ("0", "1", ...), as in the reference, so the
structural keys of ``save_parameters`` ("embed.weight",
"2.ln1.gamma", ...) match the JAX package's file for file. Gluon
``Parameter``s are kept beside, in ``_reg_params``; the automatic name
prefixes (``dense0_``) come from ``_BlockScope`` exactly as there.

A block runs eagerly: ``hybrid_forward(F, x, **params)`` gets
:mod:`mxnet_tpu_torch.ops.nn` as ``F`` and the parameters as tensors.
Outside ``autograd.record()`` it runs with torch's grad mode off, so
nothing is recorded, as in the reference. ``hybridize`` (one compiled
graph per signature) is not ported yet.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd
from ..base import NameManager
from ..ops import nn as F_ops
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name-manager for automatic prefixes (block.py _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(nn.Module):
    """Base building block (block.py:124)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._reg_params = {}
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            old = self.__dict__.get("_reg_params", {}).get(name)
            if old is not None and old is not value:
                raise AttributeError(
                    f"Overriding Parameter attribute {name} is not allowed. "
                    "If you want to share parameters between blocks, please "
                    "set 'params' at Block construction instead.")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """All Parameters of this block and its children, optionally
        filtered by the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename):
        """Values under their structural keys ("2.ln1.gamma"), in the
        reference container."""
        from ..ndarray.container import save_container
        params = self._collect_params_with_prefix()
        save_container(filename, {k: p.data().detach().cpu().numpy()
                                  for k, p in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Read a file ``save_parameters`` wrote (in either package);
        a file of full parameter names goes through
        ``collect_params().load``."""
        from ..ndarray.container import load_container
        loaded = load_container(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not any("." in k for k in loaded):
            del loaded
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError(f"Parameter '{name}' is missing in "
                                         f"file '{filename}'")
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in ParameterDict")
                continue
            params[name]._load_init(value, ctx)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the card; without
        CUDA this raises — pass ``ctx=cpu()`` to run on the host)."""
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, force_reinit)

    def __call__(self, *args):
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block whose computation is ``hybrid_forward(F, x, *args,
    **params)`` (block.py:429), run eagerly."""

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{block!r} has type {type(block)}. If you are using "
                "Sequential, please try HybridSequential instead.")
        super().register_child(block, name)

    def infer_shape(self, *args):
        """Set the shapes of this block's deferred parameters from its
        inputs (each layer knows its own rule)."""
        raise ValueError(f"{type(self).__name__} cannot infer the shape of "
                         "its deferred parameters")

    def forward(self, x, *args):
        try:
            params = {k: v.data() for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(F_ops, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
