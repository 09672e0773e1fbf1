"""Gluon Parameter / ParameterDict (subset of
mxnet_tpu/gluon/parameter.py).

A ``Parameter`` holds one ``torch.Tensor`` leaf on one device: its name,
shape, initializer, ``grad_req``, ``lr_mult``/``wd_mult`` and deferred
initialization (a shape with a 0 resolves on the block's first forward).
``grad_req="write"`` overwrites the gradient on every backward, where
torch would accumulate (see :mod:`mxnet_tpu_torch.autograd`). Several
devices per parameter (and the kvstore) are not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, gpu
from .. import initializer as init_mod

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if dtype == "bfloat16" else np.dtype(dtype).name
    return getattr(torch, name)


def _context_list(ctx):
    """ctx -> [Context]; None is the card (raises without CUDA)."""
    if ctx is None:
        ctx = [gpu(0)]
    if isinstance(ctx, Context):
        ctx = [ctx]
    ctx = list(ctx)
    if len(ctx) != 1:
        raise MXNetError("the port keeps a parameter on one device; "
                         f"got contexts {ctx}")
    ctx[0].torch_device()            # resolve now: raises without CUDA
    return ctx


def _as_tensor(data):
    if isinstance(data, torch.Tensor):
        return data
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
                 allow_deferred_init=False):
        self._data = None           # the torch leaf
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
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

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
        self._data = None
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
                arr = torch.empty(self.shape, dtype=_torch_dtype(self.dtype),
                                  device=dev)
                _apply_init(init, default_init, self.name, arr)
            else:
                arr = _as_tensor(data).to(device=dev, copy=True,
                                          dtype=_torch_dtype(self.dtype))
        self._data = arr
        self._ctx = ctx
        self._deferred_init = ()
        self._hooked = False
        self._init_grad()

    def _before_accumulate(self, grad):
        # runs just before torch accumulates into .grad: "write" starts
        # from nothing, so .grad ends as this backward's gradient alone
        if self._grad_req == "write":
            self._data.grad = None

    def _init_grad(self):
        """Zero gradient buffer (the reference allocates one per
        parameter); "null" drops it and stops requiring grad."""
        if self._grad_req == "null":
            self._data.requires_grad_(False)
            self._data.grad = None
            return
        self._data.requires_grad_(True)
        if not self._hooked:
            self._data.register_hook(self._before_accumulate)
            self._hooked = True
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if self.shape is None or not all(s > 0 for s in self.shape):
            raise MXNetError(f"Cannot initialize Parameter '{self.name}' "
                             f"because it has invalid shape: {self.shape}.")
        self._init_impl(init, default_init, ctx)

    def _load_init(self, data, ctx=None):
        """Install ``data`` (numpy array or tensor) as the value,
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

    def _check_initialized(self):
        if self._data is not None:
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
        self._check_initialized()
        return self._data

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                "because grad_req='null'")
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return self._data.grad

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return list(self._deferred_init[1])
            raise RuntimeError(f"Parameter '{self.name}' has not been "
                               "initialized")
        return list(self._ctx)

    def set_data(self, data):
        """Copy ``data`` into the value in place (the leaf, its hooks and
        the optimizer's view of it stay)."""
        self._check_initialized()
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

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise AssertionError(
                        "Cannot update self with other because they have "
                        f"different Parameters with the same name '{k}'")
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def save(self, filename, strip_prefix=""):
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
                param.data().detach().cpu().numpy()
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
