"""Gluon Block / HybridBlock / SymbolBlock (counterpart of
mxnet_tpu/gluon/block.py), as ``torch.nn.Module`` subclasses.

Children live in ``nn.Module``'s own registry: a block assigned to an
attribute is registered under that name, and ``register_child`` adds one
under the next index ("0", "1", ...), as in the reference, so the
structural keys of ``save_parameters`` ("embed.weight",
"2.ln1.gamma", ...) match the JAX package's file for file. Gluon
``Parameter``s are kept beside, in ``_reg_params``; the automatic name
prefixes (``dense0_``) come from ``_BlockScope`` exactly as there. Where
a name is also ``nn.Module``'s (``apply``, ``register_forward_hook``,
``register_forward_pre_hook``), the reference's meaning holds: ``apply``
returns the block, a hook is called as ``hook(block, args[, out])`` and
its return value is ignored.

Blocks take and return NDArrays. ``hybrid_forward(F, x, *args,
**params)`` gets ``F = mx.nd`` (the registry's generated functions) and
the parameters as NDArrays when called with NDArrays, and ``F = mx.sym``
and the parameters' variables when called with a Symbol. ``hybridize()``
traces it once with Symbols (``_get_graph``) and then runs the traced
graph through the executor's walk (``executor._Plan``, one a graph, mode,
device and input signature), with torch's grad mode on inside
``autograd.record()`` so that a backward reaches the parameters' leaves;
BatchNorm's moving statistics are written back outside the tape.
Deferred parameter shapes come from the traced Symbol's
``infer_shape_partial``, eager or hybridized. ``export`` writes the
``-symbol.json`` / ``.params`` pair that ``Module`` and
``SymbolBlock.imports`` read, in either package.

A block called with ``torch.Tensor``s (the port's earlier Gluon took and
returned tensors) wraps them as NDArrays and returns tensors.
"""
from __future__ import annotations

import copy
import re
import threading
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from ..base import NameManager
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .. import ndarray as ndmod
from .. import symbol as symmod
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .utils import MeshNDArray

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


def _flatten_args(args):
    """Nested list/tuple args -> leaves + a structure descriptor
    (hybridized calls may pass lists of states)."""
    flat = []

    def rec(a):
        if isinstance(a, (list, tuple)):
            return tuple(rec(x) for x in a)
        flat.append(a)
        return len(flat) - 1

    fmt = tuple(rec(a) for a in args)
    return flat, fmt


def _regroup_args(flat, fmt):
    def rec(f):
        if isinstance(f, tuple):
            return [rec(x) for x in f]
        return flat[f]
    return [rec(f) for f in fmt]


def _map_nested(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_map_nested(fn, a) for a in x)
    return fn(x)


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


class _HookHandle:
    """Removes a forward hook (``detach``)."""

    def __init__(self, hooks, key):
        self._hooks, self._key = hooks, key

    def detach(self):
        self._hooks.pop(self._key, None)


class Block(nn.Module):
    """Base building block (block.py:124)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._reg_params = {}
        self._gluon_pre_hooks = OrderedDict()
        self._gluon_hooks = OrderedDict()
        self._hook_count = 0
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {_indent(repr(block), 2)}"
                           for key, block in self._children.items())
        name = self.__class__.__name__
        return f"{name}(\n{modstr}\n)" if modstr else f"{name}()"

    def __setattr__(self, name, value):
        existing = self.__dict__.get(name, None) if name != "_modules" \
            else None
        if existing is None and "_modules" in self.__dict__:
            existing = self._modules.get(name)
        if isinstance(existing, (Parameter, Block)) and \
                not isinstance(value, type(existing)):
            raise TypeError(
                f"Changing attribute type for {self.name} from "
                f"{type(existing)} to {type(value)} is not allowed.")
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
        save_container(filename, {k: p.data().asnumpy()
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

    save_params = save_parameters

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def _add_hook(self, hooks, hook):
        key = self._hook_count
        self._hook_count += 1
        hooks[key] = hook
        return _HookHandle(hooks, key)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward; its return value is
        ignored. Returns a handle whose ``detach()`` removes it."""
        return self._add_hook(self._gluon_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, args, outputs)`` after each forward; its return
        value is ignored. Returns a handle whose ``detach()`` removes
        it."""
        return self._add_hook(self._gluon_hooks, hook)

    def apply(self, fn):
        """``fn(block)`` on every child, recursively, then on this block;
        returns this block."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the card; without
        CUDA this raises — pass ``ctx=cpu()`` to run on the host)."""
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast this block's Gluon parameters (and its children's)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        if any(isinstance(a, (torch.Tensor, list, tuple)) for a in args) \
                and any(isinstance(a, torch.Tensor)
                        for a in _flatten_args(args)[0]):
            nds = _map_nested(lambda a: NDArray(a) if isinstance(
                a, torch.Tensor) else a, args)
            out = self(*nds)
            return _map_nested(lambda o: o._data if isinstance(
                o, NDArray) else o, out)
        recording = autograd.is_recording()
        if torch.is_grad_enabled() != recording:
            with torch.set_grad_enabled(recording):
                return self(*args)
        for hook in list(self._gluon_pre_hooks.values()):
            hook(self, args)
        out = self.forward(*args)
        for hook in list(self._gluon_hooks.values()):
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each layer's output shape and parameter count for one
        forward of ``inputs`` (the reference's table; the block must not
        be hybridized)."""
        summary = OrderedDict()
        seen = set()
        hooks = []

        def shape_str(args):
            flat, fmt = _flatten_args(args if isinstance(args, (list, tuple))
                                      else (args,))
            shapes = _regroup_args([a.shape if isinstance(a, NDArray) else a
                                    for a in flat], fmt)
            if not isinstance(args, (list, tuple)):
                return str(shapes[0])
            return str(shapes)[1:-1]

        def hook(block, _, outputs):
            if any(isinstance(o, Symbol) for o in _flatten_args(
                    outputs if isinstance(outputs, (list, tuple))
                    else (outputs,))[0]):
                return          # a deferred shape's trace, not the run
            key = f"{block.__class__.__name__}-{len(summary)}"
            entry = summary[key] = OrderedDict()
            entry["output_shape"] = shape_str(outputs)
            entry["n_params"] = entry["trainable"] = entry["shared"] = 0
            for p in block.params.values():
                size = p.data().size
                entry["n_params"] += size
                entry["trainable"] += 0 if p.grad_req == "null" else size
                if p in seen:
                    entry["shared"] += size
                else:
                    seen.add(p)

        def register(block):
            if isinstance(block, HybridBlock) and block._active:
                raise AssertionError(f'"{block.name}" must not be '
                                     "hybridized to print summary.")
            from .nn.basic_layers import HybridSequential, Sequential
            if not isinstance(block, (Sequential, HybridSequential)):
                hooks.append(block.register_forward_hook(hook))

        summary["Input"] = OrderedDict(output_shape=shape_str(inputs),
                                       n_params=0, trainable=0, shared=0)
        try:
            self.apply(register)
            self(*inputs)
            fmt = "{:>20}  {:>42} {:>15}"
            lines = ["-" * 80, fmt.format("Layer (type)", "Output Shape",
                                          "Param #"), "=" * 80]
            total = trainable = shared = 0
            for layer, e in summary.items():
                lines.append(fmt.format(layer, str(e["output_shape"]),
                                        e["n_params"]))
                total += e["n_params"]
                trainable += e["trainable"]
                shared += e["shared"]
            lines += ["=" * 80,
                      "Parameters in forward computation graph, duplicate "
                      "included",
                      f"   Total params: {total}",
                      f"   Trainable params: {trainable}",
                      f"   Non-trainable params: {total - trainable}",
                      f"Shared params in forward computation graph: {shared}",
                      f"Unique parameters in model: {total - shared}",
                      "-" * 80]
            print("\n".join(lines))
        finally:
            for h in hooks:
                h.detach()


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line
                                    for line in lines)


class HybridBlock(Block):
    """Block whose computation is ``hybrid_forward(F, x, *args,
    **params)`` (block.py:429): eager through ``mx.nd``, or, after
    ``hybridize()``, one traced Symbol run through the executor's walk."""

    def __init__(self, prefix=None, params=None):
        self._active = False
        self._flags = {}
        self._cached_graph = ()
        self._cached_plans = {}
        self._cached_fmt = None
        self._out_fmt = None
        super().__init__(prefix=prefix, params=params)

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                f"{block!r} has type {type(block)}. If you are using "
                "Sequential, please try HybridSequential instead.")
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """Run the traced graph from the next call on (``active``) or
        eagerly again; either way the next call traces afresh."""
        self._active = active
        self._flags = kwargs
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_plans = {}
        self._cached_fmt = None
        self._out_fmt = None

    def _get_graph(self, *args):
        """Trace ``hybrid_forward`` with Symbols. Nested list args are
        flattened to ``data{i}`` variables and regrouped for the trace;
        a later call with another argument structure raises instead of
        reusing a graph of another shape."""
        flat_args, fmt = _flatten_args(args)
        if self._cached_graph:
            if self._cached_fmt != fmt:
                raise ValueError(
                    f"Hybridized {self.name}: call argument structure "
                    f"{fmt} does not match the structure it was first "
                    f"traced with {self._cached_fmt}. Call hybridize() "
                    "again to re-trace.")
            return self._cached_graph
        inputs = [symmod.var(f"data{i}") for i in range(len(flat_args))] \
            if len(flat_args) > 1 else [symmod.var("data")]
        grouped = _regroup_args(inputs, fmt)
        params = {name: param.var()
                  for name, param in self._reg_params.items()}
        with self.name_scope():
            out = self.hybrid_forward(symmod, *grouped, **params)
        is_seq = isinstance(out, (list, tuple))
        flat_out, out_fmt = _flatten_args(out if is_seq else (out,))
        self._out_fmt = out_fmt if is_seq else None
        if is_seq:
            out = symmod.Group(list(flat_out))
        self._cached_graph = (inputs, out)
        self._cached_fmt = fmt
        return self._cached_graph

    def infer_shape(self, *args):
        """Set the parameters' shapes from the inputs' (the traced
        Symbol's ``infer_shape_partial``)."""
        flat_args, _ = _flatten_args(args)
        inputs, out = self._get_graph(*args)
        arg_shapes, _, aux_shapes = out.infer_shape_partial(
            **{inp.name: tuple(arg.shape)
               for inp, arg in zip(inputs, flat_args)})
        shapes = dict(zip(out.list_arguments(), arg_shapes))
        shapes.update(zip(out.list_auxiliary_states(), aux_shapes))
        for _, param in self.collect_params().items():
            if shapes.get(param.name) is not None:
                param.shape = tuple(shapes[param.name])

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError(
                "Deferred initialization failed because shape cannot be "
                "inferred. " + str(e)) from e

    def _finish_deferred(self, *args):
        self._deferred_infer_shape(*args)
        for _, p in self.collect_params().items():
            p._finish_deferred_init()

    def _call_cached_graph(self, *args):
        """Run the traced graph on the inputs and the parameters: one
        walk of ``executor._Plan`` (recorded by torch's autograd inside
        ``autograd.record()``), then the aux write-back."""
        from .. import random as _random
        from ..executor import _Plan, _run_mesh

        flat_args, _ = _flatten_args(args)
        inputs, out = self._get_graph(*args)
        args_n, aux_n = out._input_vars()
        params = {p.name: p for _, p in self.collect_params().items()}
        given = {inp.name: a for inp, a in zip(inputs, flat_args)}
        ctx = _first_ctx(flat_args)
        # inputs sharded on axis 0 over a mesh run through the mesh walk
        sharded = {n: a for n, a in given.items()
                   if isinstance(a, MeshNDArray) and a.batch_axis == 0
                   and len(a.contexts) > 1}
        on_mesh = next(iter(sharded.values()), None)
        arg_t = {}
        for n in args_n:
            a = given[n.name] if n.name in given else params[n.name].data(ctx)
            arg_t[n.name] = a._data
        aux_t = {n.name: params[n.name].data(ctx)._data for n in aux_n}
        is_train = autograd.is_training()
        device = ctx.torch_device()
        key = (id(out), is_train, str(device),
               tuple((tuple(t.shape), t.dtype) for t in arg_t.values()))
        plan = self._cached_plans.get(key)
        if plan is None:
            plan = self._cached_plans[key] = _Plan(out, is_train)
        rng = _random.generator(device) if plan.needs_rng else None
        with torch.set_grad_enabled(autograd.is_recording()):
            if on_mesh is None:
                outs, updates = plan.run(arg_t, aux_t, device, rng)
            else:
                outs, updates = _run_mesh(plan, arg_t, aux_t,
                                          on_mesh.mesh.replicas,
                                          set(sharded), rng)
        with torch.no_grad():
            for name, value in updates:
                aux_t[name].copy_(value)
        if on_mesh is None:
            outputs = [NDArray(o) for o in outs]
        else:
            carry = plan.batch_carriers(set(sharded))
            outputs = [MeshNDArray(o, on_mesh.contexts, 0)
                       if q in carry else NDArray(o)
                       for o, (q, _) in zip(outs, plan.outputs)]
        if self._out_fmt is not None:
            regrouped = _regroup_args(outputs, self._out_fmt)
            return tuple(regrouped) if len(regrouped) > 1 else regrouped[0]
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def forward(self, x, *args):
        """NDArrays: the traced graph once hybridized, else
        ``hybrid_forward`` with ``mx.nd`` and the parameters' NDArrays;
        a Symbol: ``hybrid_forward`` with ``mx.sym`` and the parameters'
        variables."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_graph(x, *args)
                except DeferredInitializationError:
                    self._finish_deferred(x, *args)
                    return self._call_cached_graph(x, *args)
            # the parameters' value on the input's context (a parameter
            # not there raises, as in the JAX package). A mesh array is
            # the whole batch on its first context's device, which the
            # eager ops compute there (the JAX package's SPMD result)
            ctx = _first_ctx((x,) + args)
            try:
                params = {k: v.data(ctx)
                          for k, v in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                params = {k: v.data(ctx)
                          for k, v in self._reg_params.items()}
            return self.hybrid_forward(ndmod, x, *args, **params)
        if not isinstance(x, Symbol):
            raise TypeError("HybridBlock requires the first argument to "
                            "forward be either Symbol or NDArray, but got "
                            f"{type(x)}")
        params = {k: v.var() for k, v in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(symmod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``{path}-symbol.json`` (the traced graph) and
        ``{path}-{epoch:04d}.params`` (``arg:`` / ``aux:`` names), the
        pair ``Module`` and ``SymbolBlock.imports`` load."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = self._cached_graph[1]
        sym.save(f"{path}-symbol.json")
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for _, param in self.collect_params().items():
            if param.name in arg_names:
                arg_dict[f"arg:{param.name}"] = param.data()
            elif param.name in aux_names:
                arg_dict[f"aux:{param.name}"] = param.data()
        ndmod.save("%s-%04d.params" % (path, epoch), arg_dict)


def _first_ctx(args):
    """The context of the first NDArray (a mesh array's first context)."""
    for a in args:
        if isinstance(a, NDArray):
            return a.contexts[0] if isinstance(a, MeshNDArray) \
                else a.context
    return current_context()


class SymbolBlock(HybridBlock):
    """A Symbol as a callable HybridBlock (block.py:665): its arguments
    other than ``inputs`` are the block's parameters (aux states with
    grad_req "null")."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        sym = symmod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [symmod.var(i) for i in input_names]
        ret = SymbolBlock(sym, inputs)
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        if isinstance(inputs, Symbol) and len(inputs) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = symmod.Group(list(outputs))
        syms = inputs if isinstance(inputs, list) else [inputs]
        input_names = {s.name for s in syms}
        for name in outputs.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True,
                                grad_req="null")
        self._cached_graph = (syms, outputs)
        self._cached_fmt = tuple(range(len(syms)))

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_graph(x, *args)
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                return self._call_cached_graph(x, *args)
        if not isinstance(x, Symbol):
            raise TypeError("SymbolBlock takes NDArrays or Symbols, got "
                            f"{type(x)}")
        ret = copy.copy(self._cached_graph[1])
        ret._compose(**{self._cached_graph[0][i].name: v
                        for i, v in enumerate([x] + list(args))})
        return ret

    def _clear_cached_op(self):
        graph = getattr(self, "_cached_graph", ())
        fmt = getattr(self, "_cached_fmt", None)
        super()._clear_cached_op()
        self._cached_graph = graph
        self._cached_fmt = fmt

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
