"""Custom operators: ``mx.operator.CustomOp`` / ``CustomOpProp`` /
``register`` and the ``Custom`` op (counterpart of
mxnet_tpu/operator.py).

A registered ``CustomOpProp`` names its arguments and outputs, infers
their shapes and types, and creates the ``CustomOp`` whose ``forward`` /
``backward`` run on the host on numpy arrays, as in the JAX package (its
``jax.pure_callback``), so one user class body runs in both packages.
Here the op is a ``torch.autograd.Function``: the forward copies its
inputs to the host, calls ``prop.create_operator(...).forward`` and
copies the outputs back to the inputs' device; the backward calls a
fresh operator's ``backward`` with the cotangents, the inputs and the
forward's saved outputs (the forward is not run again). One operator is
created per forward and per backward, as the JAX package's host
functions do, so an op that seeds its sampling in ``__init__`` draws
alike in both packages. Auxiliary states raise, as there.

A host call cannot be captured in a CUDA graph: a data-parallel step
over a graph that holds ``Custom`` runs eagerly on the card
(``parallel/dp.py``; :func:`custom_types` names the ops it holds).
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .base import MXNetError
from .ops.registry import AttrDict, Param, register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]


class CustomOp:
    """Base class of a user's forward / backward."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the grad_req says."""
        if req in ("null", None):
            return
        if req == "add":
            dst[:] = dst[:] + src if hasattr(dst, "__getitem__") else dst + src
        else:  # write / inplace
            dst[:] = src


class CustomOpProp:
    """The op's metadata: arguments, outputs, shapes, types, the
    operator."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


_PROP_REGISTRY = {}


def register(reg_name):
    """Decorator: ``mx.operator.register("myop")(MyProp)``; then
    ``mx.nd.Custom(..., op_type="myop")`` and ``mx.sym.Custom(...)``."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _PROP_REGISTRY[reg_name] = prop_cls
        _prop_for.cache_clear()
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_PROP_REGISTRY)


@functools.lru_cache(maxsize=None)
def _prop_for(op_type, frozen_extra):
    cls = _PROP_REGISTRY.get(op_type)
    if cls is None:
        raise MXNetError(f"Custom op_type {op_type!r} is not registered")
    return cls(**dict(frozen_extra))


def _prop(attrs):
    extra = tuple(sorted((attrs.get("_extra") or {}).items()))
    return _prop_for(attrs["op_type"], extra)


_TORCH_OF = {_np.dtype(k): v for k, v in (
    ("float32", torch.float32), ("float64", torch.float64),
    ("float16", torch.float16), ("int32", torch.int32),
    ("int64", torch.int64), ("uint8", torch.uint8), ("int8", torch.int8),
    ("bool", torch.bool))}


def _np_dtype(t):
    if t == torch.bfloat16:
        raise MXNetError("Custom: numpy has no bfloat16")
    return _np.dtype(str(t).replace("torch.", ""))


def _host(t):
    return t.detach().to("cpu").numpy()


class _CustomFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *inputs):
        prop, is_train, out_shapes, out_dtypes = spec
        in_shapes = [tuple(x.shape) for x in inputs]
        in_dtypes = [_np_dtype(x.dtype) for x in inputs]
        in_data = [_host(x) for x in inputs]
        out_data = [_np.zeros(s, t) for s, t in zip(out_shapes, out_dtypes)]
        op = prop.create_operator(None, in_shapes, in_dtypes)
        op.forward(is_train, ["write"] * len(out_data), in_data, out_data,
                   [])
        dev = inputs[0].device
        outs = tuple(torch.from_numpy(_np.ascontiguousarray(o)).to(dev)
                     for o in out_data)
        ctx.spec = (prop, in_shapes, in_dtypes, in_data, out_data, dev)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        prop, in_shapes, in_dtypes, in_data, out_data, dev = ctx.spec
        cts = [_np.zeros(o.shape, o.dtype) if g is None else _host(g)
               for g, o in zip(grads, out_data)]
        op = prop.create_operator(None, in_shapes, in_dtypes)
        in_grad = [_np.zeros(s, t) for s, t in zip(in_shapes, in_dtypes)]
        op.backward(["write"] * len(in_grad), cts, in_data, out_data,
                    in_grad, [])
        return (None,) + tuple(torch.from_numpy(_np.ascontiguousarray(g))
                               .to(dev) for g in in_grad)


def _custom_fcompute(attrs, octx, *inputs):
    op_type = attrs["op_type"]
    prop = _prop(attrs)
    n_args = len(prop.list_arguments())
    if prop.list_auxiliary_states():
        raise MXNetError("Custom: auxiliary states are not supported")
    if len(inputs) != n_args:
        raise MXNetError(f"Custom({op_type}): expected {n_args} inputs, "
                         f"got {len(inputs)}")
    in_shapes = [list(x.shape) for x in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    _, out_dtypes, _ = prop.infer_type([_np_dtype(x.dtype) for x in inputs])
    out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
    out_dtypes = [_np.dtype(t) for t in out_dtypes]
    if inputs[0].device.type == "meta":         # shape inference
        return tuple(torch.empty(s, dtype=_TORCH_OF[t], device="meta")
                     for s, t in zip(out_shapes, out_dtypes))
    return tuple(_CustomFn.apply(
        (prop, bool(octx.is_train), out_shapes, out_dtypes), *inputs))


def _custom_infer_shape(attrs, in_shapes):
    prop = _prop(attrs)
    if any(s is None for s in in_shapes):
        return in_shapes, [None] * len(prop.list_outputs())
    ins, outs, _ = prop.infer_shape([list(s) for s in in_shapes])
    return [tuple(s) for s in ins], [tuple(s) for s in outs]


def _custom_list_inputs(attrs):
    return list(_prop(attrs).list_arguments())


def _custom_parse_attrs(kwargs):
    """Custom takes any user kwargs and passes them to the Prop's
    constructor."""
    if kwargs.get("op_type") is None:
        raise MXNetError("Custom: required param 'op_type' missing")
    skip = {"op_type", "name", "attr", "out", "dtype_hint", "__layout__"}
    out = AttrDict()
    out["op_type"] = str(kwargs["op_type"])
    extra = {k: v for k, v in kwargs.items()
             if k not in skip and v is not None}
    out["_extra"] = extra or None
    return out


_custom_schema = _register_op(
    "Custom", _custom_fcompute,
    params={"op_type": Param("str", None, True),
            "_extra": Param("any", None)},
    inputs=("data",), infer_shape=_custom_infer_shape)
_custom_schema.list_inputs = _custom_list_inputs
_custom_schema.num_inputs = lambda attrs: len(_custom_list_inputs(attrs))
_custom_schema.num_outputs = lambda attrs: len(_prop(attrs).list_outputs())
_custom_schema.parse_attrs = _custom_parse_attrs


def custom_types(plan):
    """The op types of the ``Custom`` nodes an executor plan
    (``executor._Plan``) runs, sorted."""
    return sorted({parsed["op_type"] for _, op, parsed, *_ in plan.steps
                   if op is _custom_schema})
