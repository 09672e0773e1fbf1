"""The ``mx.nd`` namespace: NDArray, its factories, and one function per
registered op that runs it imperatively (counterpart of
mxnet_tpu/ndarray/__init__.py; the reference generates them from its op
registry, python/mxnet/ndarray/register.py)."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from .. import imperative as _imp
from .ndarray import (NDArray, array, zeros, ones, full, empty,  # noqa: F401
                      arange, zeros_like, ones_like, concatenate, save, load,
                      waitall, moveaxis)
from . import random  # noqa: F401


def _make_op_func(schema):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)
        inputs = list(args)
        if not schema.key_var_num_args:
            # trailing non-NDArray positionals are params in declaration
            # order (the reference's generated signatures: clip(x, lo, hi))
            n_lead = 0
            while n_lead < len(inputs) and (
                    isinstance(inputs[n_lead], NDArray)
                    or inputs[n_lead] is None):
                n_lead += 1
            if n_lead < len(inputs):
                extras = inputs[n_lead:]
                inputs = inputs[:n_lead]
                pnames = [p for p in schema.params if p not in kwargs]
                for pname, val in zip(pnames, extras):
                    kwargs[pname] = val
            named = {}
            for iname in schema.input_names:
                if iname in kwargs and (isinstance(kwargs[iname], NDArray)
                                        or kwargs[iname] is None):
                    named[iname] = kwargs.pop(iname)
            if named:
                merged, ai = [], 0
                for iname in schema.input_names:
                    if iname in named:
                        if named[iname] is not None:
                            merged.append(named[iname])
                    elif ai < len(inputs):
                        merged.append(inputs[ai])
                        ai += 1
                inputs = merged + list(inputs[ai:])
        else:
            kwargs.setdefault(schema.key_var_num_args, len(inputs))
        inputs = [x for x in inputs if x is not None]
        return _imp.invoke(schema, inputs, kwargs, out=out, ctx=ctx)

    fn.__name__ = schema.name
    fn.__doc__ = f"Imperative invocation of operator `{schema.name}`."
    return fn


_self_module = _sys.modules[__name__]
for _name, _schema in list(_registry._REGISTRY.items()):
    if not hasattr(_self_module, _name):
        setattr(_self_module, _name, _make_op_func(_schema))


def __getattr__(name):
    """Ops registered after import appear here on first use."""
    schema = _registry._REGISTRY.get(name)
    if schema is None:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                             f"attribute {name!r}")
    fn = _make_op_func(schema)
    setattr(_self_module, name, fn)
    return fn


add = getattr(_self_module, "broadcast_add")
subtract = getattr(_self_module, "broadcast_sub")
multiply = getattr(_self_module, "broadcast_mul")
divide = getattr(_self_module, "broadcast_div")
power = getattr(_self_module, "broadcast_power")
maximum = getattr(_self_module, "broadcast_maximum")
minimum = getattr(_self_module, "broadcast_minimum")
equal = getattr(_self_module, "broadcast_equal")
not_equal = getattr(_self_module, "broadcast_not_equal")
greater = getattr(_self_module, "broadcast_greater")
greater_equal = getattr(_self_module, "broadcast_greater_equal")
lesser = getattr(_self_module, "broadcast_lesser")
lesser_equal = getattr(_self_module, "broadcast_lesser_equal")
