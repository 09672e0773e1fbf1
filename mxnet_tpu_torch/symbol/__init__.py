"""The ``mx.sym`` namespace: Symbol and one composition function per
registered op (counterpart of mxnet_tpu/symbol/__init__.py).

Ops without a ``name`` are named by the current ``NameManager`` from
``schema.name.lower().lstrip("_")`` (``convolution0``, ``fullyconnected1``),
as the JAX package names them, so ``list_arguments()`` gives its names
letter for letter (``convolution0_weight``)."""
from __future__ import annotations

import sys as _sys

from ..base import AttrScope, NameManager
from ..ops import registry as _registry
from ..ops.registry import get_op
from .symbol import (Symbol, Variable, var, Group, load, load_json,  # noqa
                     _Node)
from . import contrib, random  # noqa: F401

_SYM_FUNCS = {}


def _create_symbol(op_name, sym_inputs, attrs, name=None, user_attrs=None):
    schema = get_op(op_name)
    parsed = schema.parse_attrs(attrs)
    hint = schema.name.lower().lstrip("_")
    name = NameManager.current().get(name, hint)
    ua = AttrScope.current().get(user_attrs)

    entries = []
    queue = list(sym_inputs)
    for iname in schema.list_inputs(parsed):
        if queue:
            entries.append(queue.pop(0)._outputs[0])
        else:
            # auto-create the parameter variable `{name}_{input}`
            entries.append((_Node(None, f"{name}_{iname}", {}, [], {}), 0))
    node = _Node(schema, name, attrs, entries, ua)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_sym_func(schema):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        user_attrs = kwargs.pop("attr", None)
        sym_inputs = [a for a in args if isinstance(a, Symbol)]
        extras = [a for a in args if not isinstance(a, Symbol)]
        if not schema.key_var_num_args:
            named = {}
            for iname in schema.input_names:
                if iname in kwargs and isinstance(kwargs[iname], Symbol):
                    named[iname] = kwargs.pop(iname)
            if named:
                merged, qi = [], 0
                for iname in schema.input_names:
                    if iname in named:
                        merged.append(named[iname])
                    elif qi < len(sym_inputs):
                        merged.append(sym_inputs[qi])
                        qi += 1
                    else:
                        break
                sym_inputs = merged + sym_inputs[qi:]
        else:
            kwargs.setdefault(schema.key_var_num_args, len(sym_inputs))
        if extras:
            pnames = [p for p in schema.params if p not in kwargs]
            for pname, val in zip(pnames, extras):
                kwargs[pname] = val
        return _create_symbol(schema.name, sym_inputs, kwargs, name=name,
                              user_attrs=user_attrs)

    fn.__name__ = schema.name
    fn.__doc__ = f"Symbolic composition of operator `{schema.name}`."
    return fn


_self_module = _sys.modules[__name__]
for _name, _schema in list(_registry._REGISTRY.items()):
    if not hasattr(_self_module, _name):
        _f = _make_sym_func(_schema)
        setattr(_self_module, _name, _f)
        _SYM_FUNCS[_name] = _f

zeros = getattr(_self_module, "_zeros")
ones = getattr(_self_module, "_ones")
arange = getattr(_self_module, "_arange")


def __getattr__(name):
    """Ops registered after import appear here on first use."""
    schema = _registry._REGISTRY.get(name)
    if schema is None:
        raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no "
                             f"attribute {name!r}")
    fn = _make_sym_func(schema)
    setattr(_self_module, name, fn)
    _SYM_FUNCS[name] = fn
    return fn
