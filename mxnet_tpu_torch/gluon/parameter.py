"""Gluon Parameter / ParameterDict (counterpart of
mxnet_tpu/gluon/parameter.py).

A ``Parameter`` holds one ``torch.Tensor`` leaf on one device (``_data``)
and hands it out as an NDArray over that leaf (``data()``; ``grad()`` is
an NDArray over the leaf's ``.grad``): its name, shape, dtype,
initializer, ``grad_req``, ``lr_mult``/``wd_mult`` and deferred
initialization (a shape with a 0 resolves on the block's first forward).
The leaf is an autograd variable (``autograd._mark``): ``grad_req=
"write"`` overwrites the gradient on every backward, where torch would
accumulate. ``var()`` is the parameter's Symbol for a hybridized trace.

Several contexts: as in the JAX package, every context maps to the same
value, one leaf on the first context's device (replicated over the mesh
of those contexts, which a hybridized block's mesh walk copies to each
replica); ``list_data()`` and ``list_grad()`` give that one buffer under
each context, and ``data(ctx)`` for a context that was not given raises.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context, gpu
from .. import autograd
from .. import initializer as init_mod

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


def _context_list(ctx):
    """ctx -> [Context]; None is the card (raises without CUDA)."""
    if ctx is None:
        ctx = [gpu(0)]
    if isinstance(ctx, Context):
        ctx = [ctx]
    ctx = list(ctx)
    for c in ctx:
        c.torch_device()             # resolve now: raises without CUDA
    return ctx


def _as_tensor(data):
    from ..ndarray.ndarray import NDArray
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    return torch.from_numpy(np.array(data))   # a copy: container reads
                                              # are read-only views


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization."""


def _apply_init(init, default_init, name, data):
    """A parameter's own initializer applies wholesale (through the
    ``__init__`` attr), the global one by name suffix."""
    if init is not None and init is not default_init and \
            isinstance(init, init_mod.Initializer):
        init(init_mod.InitDesc(name, {"__init__": init.dumps()}), data)
    elif init is not None:
        init(init_mod.InitDesc(name, {}), data)
    else:
        default_init(init_mod.InitDesc(name, {}), data)


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None           # the torch leaf
        self._nd = None             # the NDArray over it
        self._ctx = None            # [Context]
        self._deferred_init = ()
        self.name = name
        self._grad_req = None
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._differentiable = differentiable
        self.grad_req = grad_req
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add, or null, but got "
                             f"{req}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            autograd._mark(self._data, req)

    # -- initialization -----------------------------------------------------

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            import warnings
            warnings.warn(f"Parameter '{self.name}' is already initialized, "
                          "ignoring. Set force_reinit=True to re-initialize.",
                          stacklevel=2)
            return
        self._data = self._nd = None
        ctx = _context_list(ctx)
        if not isinstance(default_init, init_mod.Initializer):
            default_init = init_mod.create(default_init)
        # precedence: explicit init arg > param's own init > default_init
        if init is None:
            init = self.init if self.init is not None else default_init
        if isinstance(init, str):
            init = init_mod.create(init)
        if self.shape is None or any(s <= 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                f"Cannot initialize Parameter '{self.name}' because it has "
                f"invalid shape: {self.shape}.")
        self._init_impl(init, default_init, ctx)

    def _init_impl(self, init, default_init, ctx, data=None):
        dev = ctx[0].torch_device()
        with torch.no_grad():
            if data is None:
                arr = torch.empty(self.shape, dtype=torch_dtype(self.dtype),
                                  device=dev)
                _apply_init(init, default_init, self.name, arr)
            else:
                arr = _as_tensor(data).to(device=dev, copy=True,
                                          dtype=torch_dtype(self.dtype))
        self._set_leaf(arr)
        self._ctx = ctx
        self._deferred_init = ()

    def _set_leaf(self, t):
        from ..ndarray.ndarray import NDArray
        self._data = autograd._mark(t, self._grad_req)
        if self._nd is None:
            self._nd = NDArray(self._data)
        else:
            self._nd._data = self._data

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if self.shape is None or not all(s > 0 for s in self.shape):
            raise MXNetError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self.shape}.")
        self._init_impl(init, default_init, ctx)

    def _load_init(self, data, ctx=None):
        """Install ``data`` (numpy array, tensor or NDArray) as the value,
        finishing a deferred initialization or replacing the current one."""
        shape = tuple(data.shape)
        if self.shape:
            for mine, theirs in zip(self.shape, shape):
                if mine not in (0, theirs) or len(self.shape) != len(shape):
                    raise MXNetError(
                        f"Failed loading Parameter '{self.name}' from saved "
                        f"params: shape incompatible expected {self.shape} "
                        f"vs saved {shape}")
        self.shape = shape
        if self._data is not None:
            self.set_data(data)
            return
        if self._deferred_init:
            ctx = self._deferred_init[1]
        else:
            ctx = _context_list(ctx)
        self._init_impl(None, None, ctx, data=data)

    # -- access -------------------------------------------------------------

    def _check_initialized(self, ctx=None):
        """Raise unless initialized (on ``ctx``; None: the current context
        when there are several, ``list``: any)."""
        if self._data is not None:
            if ctx is None and len(self._ctx) > 1:
                ctx = current_context()
            if ctx is not None and ctx is not list and ctx not in self._ctx:
                raise RuntimeError(
                    f"Parameter '{self.name}' was not initialized on context "
                    f"{ctx}. It was only initialized on {self._ctx}.")
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                f"Parameter '{self.name}' has not been initialized yet "
                "because initialization was deferred. Actual initialization "
                "happens during the first forward pass. Please pass one "
                "batch of data through the network before accessing "
                "Parameters.")
        raise RuntimeError(
            f"Parameter '{self.name}' has not been initialized. Note that "
            "you should initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks")

    def data(self, ctx=None):
        """The value, an NDArray over the parameter's leaf tensor (the
        same NDArray on every call and for every context)."""
        self._check_initialized(ctx)
        return self._nd

    def list_data(self):
        """The value under each context: one NDArray, repeated."""
        self._check_initialized(list)
        return [self._nd] * len(self._ctx)

    def grad(self, ctx=None):
        """The gradient buffer, an NDArray over the leaf's ``.grad``."""
        from ..ndarray.ndarray import NDArray
        self._check_initialized(ctx)
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return NDArray(self._data.grad)

    def list_grad(self):
        """The gradient under each context: one NDArray, repeated."""
        return [self.grad(list)] * len(self._ctx or ())

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return list(self._deferred_init[1])
            raise RuntimeError(f"Parameter '{self.name}' has not been "
                               "initialized")
        return list(self._ctx)

    def reset_ctx(self, ctx):
        """Move the value (or a deferred initialization) to ``ctx``."""
        ctx = _context_list(ctx)
        if self._data is not None:
            with torch.no_grad():
                self._set_leaf(self._data.detach().to(
                    ctx[0].torch_device(), copy=True))
            self._ctx = ctx
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)
        else:
            raise ValueError(f"Cannot reset context for Parameter "
                             f"'{self.name}' because it has not been "
                             "initialized.")

    def set_data(self, data):
        """Copy ``data`` into the value in place (the leaf, its hooks and
        the optimizer's view of it stay)."""
        self._check_initialized(list)
        src = _as_tensor(data)
        if tuple(src.shape) != tuple(self._data.shape):
            raise MXNetError(f"set_data: shape {tuple(src.shape)} does not "
                             f"match {tuple(self._data.shape)} of "
                             f"'{self.name}'")
        with torch.no_grad():
            self._data.copy_(src)

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            self._data.grad.zero_()

    def var(self):
        """This parameter's Symbol variable (for a hybridized trace)."""
        from .. import symbol as sym_mod
        if self._var is None:
            self._var = sym_mod.Variable(self.name, shape=self.shape,
                                         dtype=self.dtype,
                                         lr_mult=self.lr_mult,
                                         wd_mult=self.wd_mult,
                                         init=self.init)
        return self._var

    def cast(self, dtype):
        """Cast the value (and its gradient buffer) to ``dtype``: a new
        leaf, which the NDArray ``data()`` returns now holds."""
        self.dtype = dtype
        if self._data is None:
            return
        with torch.no_grad():
            self._set_leaf(self._data.detach().to(torch_dtype(dtype)))


class Constant(Parameter):
    """A parameter that is not learned (grad_req "null"), initialized
    from ``value``."""

    def __init__(self, name, value):
        from ..ndarray.ndarray import NDArray, array
        from ..context import cpu
        if not isinstance(value, NDArray):
            value = array(value, ctx=cpu())
        self.value = value

        class Init(init_mod.Initializer):
            def _init_weight(self2, _, arr):
                init_mod._tensor(arr).copy_(value._data)
        init_name = f"Constant_{name}_{id(self)}"
        init_mod._INIT_REGISTRY[init_name.lower()] = Init
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=init_name)


class ParameterDict:
    """Dict of Parameters with a prefix and a shared fallback."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return f"{name}(\n" + \
            "\n".join(f"  {v!r}" for v in self.values()) + "\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` if it
        does not exist; an existing one must agree with them (a 0 in a
        shape matches any size)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None and len(v) == len(existing):
                inferred = tuple(max(i, j) for i, j in zip(v, existing))
                if all(i in (0, m) and j in (0, m)
                       for i, j, m in zip(v, existing, inferred)):
                    param.shape = inferred
                    continue
            if v is not None and v != existing:
                raise AssertionError(
                    f"Cannot retrieve Parameter '{name}' because desired "
                    f"attribute does not match with stored for attribute "
                    f"'{k}': desired '{v}' vs stored '{existing}'")
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'. Please specify "
                               "value if you want to create a new constant.")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise AssertionError(
                        "Cannot update self with other because they have "
                        f"different Parameters with the same name '{k}'")
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Values under their names less ``strip_prefix``, in the
        reference container (``export`` writes ``arg:`` / ``aux:``
        names, which ``load`` strips)."""
        from ..ndarray.container import save_container
        arg_dict = {}
        for param in self.values():
            if param._data is None:
                continue
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be striped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    f"start with '{strip_prefix}'.")
            arg_dict[param.name[len(strip_prefix):]] = \
                param.data().asnumpy()
        save_container(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray.container import load_container
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        f"restore_prefix is '{restore_prefix}' but "
                        f"Parameter name '{name}' does not start with it")
        lprefix = len(restore_prefix)
        loaded = load_container(filename)
        arg_dict = {restore_prefix + (k.partition(":")[2]
                                      if k.startswith(("arg:", "aux:"))
                                      else k): v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError(
                        f"Parameter '{name[lprefix:]}' is missing in file "
                        f"'{filename}'")
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        f"Parameter '{name[lprefix:]}' loaded from file "
                        f"'{filename}' is not present in ParameterDict")
                continue
            self._params[name]._load_init(value, ctx)
