"""Tensor operators (counterpart of mxnet_tpu/ops/tensor.py, the families
the symbolic training path and the ``mx.nd`` namespace use): elementwise
unary, elementwise and broadcast binary, scalar, reductions, ``dot``,
shape manipulation, indexing and init ops, each a plain function on
tensors registered with the JAX package's name, attrs and shape rules.

MXNet semantics kept (and differing from torch's defaults):
  - comparison and logical ops return the *input* dtype (1.0 / 0.0);
  - argmax / argmin return float32 indices;
  - Reshape takes the special codes 0, -1, -2, -3, -4;
  - ``dot`` contracts the last axis of lhs with the first of rhs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import Param, register

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _same_shape_infer(attrs, in_shapes):
    """Bidirectional same-shape inference for elementwise ops."""
    known = next((s for s in in_shapes if s is not None), None)
    if known is None:
        return in_shapes, [None]
    return [known if s is None else s for s in in_shapes], [known]


def _scalar(x, s):
    """The scalar attr in x's kind (an int tensor takes an int), so the
    result keeps x's dtype as ``jnp.asarray(s, x.dtype)`` does."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return float(s)
    if x.dtype == torch.bool:
        return bool(s)
    return int(s)


# ops that compute each element from the same element of their inputs
# (of the broadcast inputs, for the broadcast family): per sample on a
# data-parallel mesh (executor._per_sample_rules)
ELEMENTWISE = {"_copy", "BlockGrad", "Cast", "add_n", "clip", "zeros_like",
               "ones_like"}


# Gradients at kinks and ties are the JAX package's (the reference for
# the port): max/min split a tie's cotangent in half, so relu, clip and
# the scalar max/min pass 0.5 of it at the kink (``torch.clamp`` and
# ``torch.relu`` pass 1 or 0), and abs passes +1 at 0 and -0.0.


def _maximum_with(x, s):
    return torch.maximum(x, s if torch.is_tensor(s) else x.new_full((), s))


def _minimum_with(x, s):
    return torch.minimum(x, s if torch.is_tensor(s) else x.new_full((), s))


class _Relu(torch.autograd.Function):
    """relu with the tie's half: the forward is ``torch.relu``, the
    backward ``g * heaviside(x, 0.5)`` (two elementwise kernels; max's
    own backward takes five)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.heaviside(x, x.new_full((), 0.5))


def relu(x):
    """max(x, 0), 0.5 of the cotangent at 0."""
    return _Relu.apply(x) if torch.is_grad_enabled() and x.requires_grad \
        else torch.relu(x)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x):
    """|x|, whose gradient is +1 at 0 and at -0.0."""
    return _Abs.apply(x) if torch.is_grad_enabled() and x.requires_grad \
        else torch.abs(x)


def _clip(x, lo, hi):
    """min(max(x, lo), hi) (numbers or tensors): 0.5 of the cotangent at
    either bound."""
    return _minimum_with(_maximum_with(x, lo), hi)


def _unary(name, fn, aliases=()):
    ELEMENTWISE.add(name)
    register(name, lambda attrs, octx, x: (fn(x),), aliases=aliases,
             infer_shape=_same_shape_infer)


def _binary(name, fn, aliases=(), cast_to_input=False, same_shape=False):
    def fcompute(attrs, octx, lhs, rhs):
        y = fn(lhs, rhs)
        return (y.to(lhs.dtype) if cast_to_input else y,)
    ELEMENTWISE.add(name)
    register(name, fcompute, inputs=("lhs", "rhs"), aliases=aliases,
             infer_shape=_same_shape_infer if same_shape else None)


def _scalar_op(name, fn, aliases=(), cast_to_input=False):
    def fcompute(attrs, octx, x):
        y = fn(x, _scalar(x, attrs["scalar"]))
        return (y.to(x.dtype) if cast_to_input else y,)
    ELEMENTWISE.add(name)
    register(name, fcompute, params={"scalar": Param("float", 0.0, True)},
             aliases=aliases, infer_shape=_same_shape_infer)


def _nonzero(x):
    return x != 0


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

_unary("relu", relu, aliases=("_relu",))
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (1 + x.abs()))
_unary("tanh", torch.tanh)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", lambda x: torch.sign(x) * x.abs().pow(1.0 / 3.0))
_unary("rcbrt", lambda x: 1.0 / (torch.sign(x) * x.abs().pow(1.0 / 3.0)))
_unary("square", torch.square)
_unary("abs", abs_)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("rint", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("negative", torch.negative, aliases=("_np_negative",))
_unary("reciprocal", torch.reciprocal)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))

register("_copy", lambda attrs, octx, x: (x.clone(),), aliases=("identity",),
         infer_shape=_same_shape_infer)
register("BlockGrad", lambda attrs, octx, x: (x.detach(),),
         aliases=("stop_gradient",), infer_shape=_same_shape_infer)
register("Cast", lambda attrs, octx, x: (x.to(torch_dtype(attrs["dtype"])),),
         params={"dtype": Param("dtype", "float32", True)},
         aliases=("cast",), infer_shape=_same_shape_infer)

# ---------------------------------------------------------------------------
# elementwise binary + broadcast families
# ---------------------------------------------------------------------------

_binary("elemwise_add", torch.add, aliases=("_plus", "_Plus"),
        same_shape=True)
_binary("elemwise_sub", torch.sub, aliases=("_minus", "_Minus"),
        same_shape=True)
_binary("elemwise_mul", torch.mul, aliases=("_mul", "_Mul"), same_shape=True)
_binary("elemwise_div", torch.true_divide, aliases=("_div", "_Div"),
        same_shape=True)
_binary("_grad_add", torch.add, same_shape=True)

_binary("broadcast_add", torch.add, aliases=("broadcast_plus",))
_binary("broadcast_sub", torch.sub, aliases=("broadcast_minus",))
_binary("broadcast_mul", torch.mul)
_binary("broadcast_div", torch.true_divide)
_binary("broadcast_mod", torch.remainder)
_binary("broadcast_power", torch.pow, aliases=("_power", "_Power"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum",))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum",))
_binary("broadcast_hypot", torch.hypot, aliases=("_hypot",))
_binary("broadcast_equal", torch.eq, cast_to_input=True,
        aliases=("_equal", "_Equal"))
_binary("broadcast_not_equal", torch.ne, cast_to_input=True,
        aliases=("_not_equal", "_Not_Equal"))
_binary("broadcast_greater", torch.gt, cast_to_input=True,
        aliases=("_greater", "_Greater"))
_binary("broadcast_greater_equal", torch.ge, cast_to_input=True,
        aliases=("_greater_equal",))
_binary("broadcast_lesser", torch.lt, cast_to_input=True,
        aliases=("_lesser", "_Lesser"))
_binary("broadcast_lesser_equal", torch.le, cast_to_input=True,
        aliases=("_lesser_equal",))
_binary("broadcast_logical_and",
        lambda a, b: torch.logical_and(_nonzero(a), _nonzero(b)),
        cast_to_input=True, aliases=("_logical_and",))
_binary("broadcast_logical_or",
        lambda a, b: torch.logical_or(_nonzero(a), _nonzero(b)),
        cast_to_input=True, aliases=("_logical_or",))
_binary("broadcast_logical_xor",
        lambda a, b: torch.logical_xor(_nonzero(a), _nonzero(b)),
        cast_to_input=True, aliases=("_logical_xor",))

_scalar_op("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda x, s: s - x, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_scalar_op("_div_scalar", torch.true_divide, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda x, s: s / x, aliases=("_RDivScalar",))
_scalar_op("_mod_scalar", torch.remainder, aliases=("_ModScalar",))
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(
    torch.full_like(x, s), x), aliases=("_RModScalar",))
_scalar_op("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x),
           aliases=("_RPowerScalar",))
_scalar_op("_maximum_scalar", _maximum_with, aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar", _minimum_with, aliases=("_MinimumScalar",))
_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(x, torch.full_like(x, s)),
           aliases=("_HypotScalar",))
_scalar_op("_equal_scalar", torch.eq, cast_to_input=True,
           aliases=("_EqualScalar",))
_scalar_op("_not_equal_scalar", torch.ne, cast_to_input=True,
           aliases=("_NotEqualScalar",))
_scalar_op("_greater_scalar", torch.gt, cast_to_input=True,
           aliases=("_GreaterScalar",))
_scalar_op("_greater_equal_scalar", torch.ge, cast_to_input=True,
           aliases=("_GreaterEqualScalar",))
_scalar_op("_lesser_scalar", torch.lt, cast_to_input=True,
           aliases=("_LesserScalar",))
_scalar_op("_lesser_equal_scalar", torch.le, cast_to_input=True,
           aliases=("_LesserEqualScalar",))
_scalar_op("_logical_and_scalar", lambda x, s: _nonzero(x) & bool(s),
           cast_to_input=True)
_scalar_op("_logical_or_scalar", lambda x, s: _nonzero(x) | bool(s),
           cast_to_input=True)
_scalar_op("_logical_xor_scalar", lambda x, s: _nonzero(x) ^ bool(s),
           cast_to_input=True)


def _add_n(attrs, octx, *inputs):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return (out,)


register("add_n", _add_n, params={"num_args": Param("int", None, True)},
         inputs=("args",), key_var_num_args="num_args",
         aliases=("ElementWiseSum", "_sum"))

# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _norm_axes(axis, ndim, exclude=False):
    if axis is None:
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _over_axes(fn):
    """A one-axis torch reduction applied over several axes (highest
    first, so the lower indices stay valid)."""
    def red(x, dim, keepdim):
        for a in sorted(dim, reverse=True):
            x = fn(x, a, keepdim)
        return x
    return red


_REDUCERS = {
    "sum": lambda x, dim, keepdim: torch.sum(x, dim=dim, keepdim=keepdim),
    "_square_sum": lambda x, dim, keepdim: torch.sum(
        torch.square(x), dim=dim, keepdim=keepdim),
    "mean": lambda x, dim, keepdim: torch.mean(x, dim=dim, keepdim=keepdim),
    "prod": _over_axes(lambda x, a, k: torch.prod(x, dim=a, keepdim=k)),
    "nansum": lambda x, dim, keepdim: torch.nansum(x, dim=dim,
                                                   keepdim=keepdim),
    "nanprod": _over_axes(lambda x, a, k: torch.prod(
        torch.nan_to_num(x, nan=1.0), dim=a, keepdim=k)),
    "max": lambda x, dim, keepdim: torch.amax(x, dim=dim, keepdim=keepdim),
    "min": lambda x, dim, keepdim: torch.amin(x, dim=dim, keepdim=keepdim),
}
_REDUCE_ALIASES = {"sum": ("sum_axis",), "max": ("max_axis",),
                   "min": ("min_axis",)}


def _reduce_op(name, fn):
    def fcompute(attrs, octx, x):
        axes = _norm_axes(attrs["axis"], x.ndim, attrs["exclude"])
        if not axes:          # no axis to reduce: torch would reduce all
            return (x.clone(),)
        return (fn(x, axes, attrs["keepdims"]),)
    register(name, fcompute,
             params={"axis": Param("shape", None),
                     "keepdims": Param("bool", False),
                     "exclude": Param("bool", False)},
             aliases=_REDUCE_ALIASES.get(name, ()))


for _n, _f in _REDUCERS.items():
    _reduce_op(_n, _f)


def _arg_reduce(fn):
    def fcompute(attrs, octx, x):
        ax = attrs["axis"]
        if ax is None:
            y = fn(x.reshape(-1), 0)
        else:
            y = fn(x, ax)
            if attrs["keepdims"]:
                y = y.unsqueeze(ax)
        return (y.to(torch.float32),)
    return fcompute


register("argmax", _arg_reduce(torch.argmax),
         params={"axis": Param("int", None), "keepdims": Param("bool", False)})
register("argmin", _arg_reduce(torch.argmin),
         params={"axis": Param("int", None), "keepdims": Param("bool", False)})
register("argmax_channel",
         lambda attrs, octx, x: (torch.argmax(x, 1).to(torch.float32),))


def _norm(attrs, octx, x):
    axes = None if attrs["axis"] is None else _norm_axes(attrs["axis"],
                                                         x.ndim)
    dim = tuple(range(x.ndim)) if axes is None else axes
    if attrs["ord"] == 1:
        return (torch.sum(x.abs(), dim=dim, keepdim=attrs["keepdims"]),)
    return (torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                 keepdim=attrs["keepdims"])),)


register("norm", _norm, params={"ord": Param("int", 2),
                                "axis": Param("shape", None),
                                "keepdims": Param("bool", False)})

# ---------------------------------------------------------------------------
# dot / batch_dot
# ---------------------------------------------------------------------------


def _flip_all(x):
    """jnp's ``.T``: every axis reversed."""
    return x.permute(*reversed(range(x.ndim))) if x.ndim > 1 else x


def _dot(attrs, octx, lhs, rhs):
    a = _flip_all(lhs) if attrs["transpose_a"] else lhs
    b = _flip_all(rhs) if attrs["transpose_b"] else rhs
    if a.ndim == 1 and b.ndim == 1:
        return (torch.dot(a, b).reshape(1),)
    return (torch.tensordot(a, b, dims=([a.ndim - 1], [0])),)


register("dot", _dot, params={"transpose_a": Param("bool", False),
                              "transpose_b": Param("bool", False)},
         inputs=("lhs", "rhs"))


def _batch_dot(attrs, octx, lhs, rhs):
    a = lhs.transpose(-1, -2) if attrs["transpose_a"] else lhs
    b = rhs.transpose(-1, -2) if attrs["transpose_b"] else rhs
    return (torch.matmul(a, b),)


register("batch_dot", _batch_dot,
         params={"transpose_a": Param("bool", False),
                 "transpose_b": Param("bool", False)},
         inputs=("lhs", "rhs"))

# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def reshape_target(shape_attr, in_shape):
    """MXNet Reshape's special codes 0, -1, -2, -3, -4
    (src/operator/tensor/matrix_op-inl.h ReshapeParam)."""
    out = []
    src = list(in_shape)
    i = 0
    k = 0
    spec = list(shape_attr)
    while k < len(spec):
        d = spec[k]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = spec[k + 1], spec[k + 2]
            cur = src[i]
            i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            k += 2
        else:
            out.append(d)
            i += 1
        k += 1
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = math.prod(in_shape) // known if known else 0
    return tuple(out)


def _reshape(attrs, octx, x):
    tgt = attrs["shape"]
    if attrs["reverse"]:
        rt = reshape_target(tuple(reversed(tgt)), tuple(reversed(x.shape)))
        return (x.reshape(tuple(reversed(rt))),)
    return (x.reshape(reshape_target(tgt, tuple(x.shape))),)


def _reshape_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    tgt = attrs["shape"]
    if attrs["reverse"]:
        return in_shapes, [tuple(reversed(reshape_target(
            tuple(reversed(tgt)), tuple(reversed(s)))))]
    return in_shapes, [reshape_target(tgt, tuple(s))]


register("Reshape", _reshape,
         params={"shape": Param("shape", (), True),
                 "reverse": Param("bool", False)},
         aliases=("reshape",), infer_shape=_reshape_infer)


def _flatten_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    return in_shapes, [(s[0], math.prod(s[1:]))]


register("Flatten", lambda attrs, octx, x: (x.reshape(x.shape[0], -1),),
         aliases=("flatten",), infer_shape=_flatten_infer)


def _transpose(attrs, octx, x):
    axes = attrs["axes"]
    return (x.permute(*axes) if axes else _flip_all(x),)


register("transpose", _transpose, params={"axes": Param("shape", ())})
register("expand_dims",
         lambda attrs, octx, x: (x.unsqueeze(attrs["axis"]),),
         params={"axis": Param("int", None, True)})


def _squeeze(attrs, octx, x):
    ax = attrs["axis"]
    if ax is None:
        return (x.squeeze(),)
    return (x.squeeze(tuple(a % x.ndim for a in ax)),)


register("squeeze", _squeeze, params={"axis": Param("shape", None)})


def _parse_slice_list(v):
    """begin/end/step attrs may hold None entries: "(0, None)"."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(None if x is None else int(x) for x in v)
    import ast
    val = ast.literal_eval(str(v))
    if not isinstance(val, (tuple, list)):
        val = (val,)
    return tuple(None if x is None else int(x) for x in val)


def _py_slice(b, e, s):
    return slice(None if b is None else int(b), None if e is None else int(e),
                 None if s is None or s == 0 else int(s))


def _slice(attrs, octx, x):
    """Python slicing per axis; torch takes no negative step, so such an
    axis is flipped and sliced forward over the flipped positions (the
    gradient flows back through the flip)."""
    begin, end, step = attrs["begin"], attrs["end"], attrs["step"]
    idx = []
    for i in range(len(begin)):
        e = end[i] if i < len(end) else None
        s = step[i] if step and i < len(step) else None
        sl = _py_slice(begin[i], e, s)
        if sl.step is not None and sl.step < 0:
            n = x.shape[i]
            picked = range(*sl.indices(n))
            x = x.flip(i)
            sl = slice(n - 1 - picked[0], n - picked[-1], -sl.step) \
                if len(picked) else slice(0, 0)
        idx.append(sl)
    return (x[tuple(idx)],)


_slice_schema = register("slice", _slice,
                         params={"begin": Param("any", None, True),
                                 "end": Param("any", None, True),
                                 "step": Param("any", None)},
                         aliases=("crop",))
for _pname in ("begin", "end", "step"):
    _slice_schema.params[_pname].parse = _parse_slice_list


def _slice_axis(attrs, octx, x):
    ax = attrs["axis"] % x.ndim
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(attrs["begin"] or 0, attrs["end"])
    return (x[tuple(idx)],)


register("slice_axis", _slice_axis,
         params={"axis": Param("int", None, True), "begin": Param("int", 0),
                 "end": Param("int", None)})
register("clip", lambda attrs, octx, x: (_clip(x, attrs["a_min"],
                                              attrs["a_max"]),),
         params={"a_min": Param("float", None, True),
                 "a_max": Param("float", None, True)},
         infer_shape=_same_shape_infer)


def _concat_infer(attrs, in_shapes):
    known = [s for s in in_shapes if s is not None]
    if not known:
        return in_shapes, [None]
    dim = attrs["dim"]
    filled = [list(known[0]) if s is None else list(s) for s in in_shapes]
    out = list(filled[0])
    out[dim] = sum(s[dim] for s in filled)
    return [tuple(s) for s in filled], [tuple(out)]


register("Concat", lambda attrs, octx, *xs: (torch.cat(xs, dim=attrs["dim"]),),
         params={"dim": Param("int", 1), "num_args": Param("int", None, True)},
         inputs=("arg",), key_var_num_args="num_args", aliases=("concat",),
         infer_shape=_concat_infer)


register("stack", lambda attrs, octx, *xs: (torch.stack(xs,
                                                        dim=attrs["axis"]),),
         params={"axis": Param("int", 0), "num_args": Param("int", None, True)},
         inputs=("arg",), key_var_num_args="num_args")


def _split(attrs, octx, x):
    n, ax = attrs["num_outputs"], attrs["axis"]
    if x.shape[ax] % n != 0:
        raise MXNetError(f"SliceChannel: axis {ax} of shape "
                         f"{tuple(x.shape)} does not split into {n} equal "
                         "parts")
    parts = torch.split(x, x.shape[ax] // n, dim=ax)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


_split_schema = register(
    "SliceChannel", _split,
    params={"num_outputs": Param("int", None, True),
            "axis": Param("int", 1),
            "squeeze_axis": Param("bool", False)},
    aliases=("split",))
_split_schema.num_outputs = lambda attrs: attrs["num_outputs"]


def _broadcast_to(attrs, octx, x):
    tgt = [x.shape[i] if d == 0 else d for i, d in enumerate(attrs["shape"])]
    return (x.expand(*tgt),)


register("broadcast_to", _broadcast_to,
         params={"shape": Param("shape", None, True)})

# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _take(attrs, octx, data, indices):
    ax = attrs["axis"] % data.ndim
    n = data.shape[ax]
    idx = indices.to(torch.int64)
    if attrs["mode"] == "clip":
        idx = idx.clamp(0, n - 1)
    elif attrs["mode"] == "wrap":
        idx = torch.remainder(idx, n)
    out = torch.index_select(data, ax, idx.reshape(-1))
    shape = data.shape[:ax] + tuple(indices.shape) + data.shape[ax + 1:]
    return (out.reshape(shape),)


register("take", _take,
         params={"axis": Param("int", 0), "mode": Param("str", "clip")},
         inputs=("a", "indices"))


def _pick(attrs, octx, data, index):
    ax = attrs["axis"]
    idx = index.to(torch.int64)
    if ax is None:
        return (data.reshape(-1)[idx.reshape(-1)].reshape(index.shape),)
    ax = ax % data.ndim
    if idx.ndim < data.ndim:
        idx = idx.unsqueeze(ax)
    idx = idx.clamp(0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx)
    return (out if attrs["keepdims"] else out.squeeze(ax),)


register("pick", _pick,
         params={"axis": Param("int", -1), "keepdims": Param("bool", False)},
         inputs=("data", "index"), aliases=("choose_element_0index",))


def _one_hot(attrs, octx, indices):
    depth = attrs["depth"]
    idx = indices.to(torch.int64)
    # jax.nn.one_hot: an index outside [0, depth) is a zero row
    valid = (idx >= 0) & (idx < depth)
    oh = torch.nn.functional.one_hot(idx.clamp(0, depth - 1), depth)
    oh = (oh * valid.unsqueeze(-1)).to(torch.float32)
    out = oh * attrs["on_value"] + (1 - oh) * attrs["off_value"]
    return (out.to(torch_dtype(attrs["dtype"])),)


register("one_hot", _one_hot,
         params={"depth": Param("int", None, True),
                 "on_value": Param("float", 1.0),
                 "off_value": Param("float", 0.0),
                 "dtype": Param("dtype", "float32")},
         inputs=("indices",))

# ---------------------------------------------------------------------------
# init ops: nullary, placed on the caller's device (OpCtx.device)
# ---------------------------------------------------------------------------


def _dt(attrs):
    return torch_dtype(attrs.get("dtype") or "float32")


register("_zeros", lambda attrs, octx: (torch.zeros(
    attrs["shape"], dtype=_dt(attrs), device=octx.device),),
    params={"shape": Param("shape", (), True),
            "dtype": Param("dtype", "float32")}, inputs=())
register("_ones", lambda attrs, octx: (torch.ones(
    attrs["shape"], dtype=_dt(attrs), device=octx.device),),
    params={"shape": Param("shape", (), True),
            "dtype": Param("dtype", "float32")}, inputs=())
register("_full", lambda attrs, octx: (torch.full(
    attrs["shape"], attrs["value"], dtype=_dt(attrs), device=octx.device),),
    params={"shape": Param("shape", (), True),
            "value": Param("float", 0.0, True),
            "dtype": Param("dtype", "float32")}, inputs=())


def _arange(attrs, octx):
    start, stop, step = attrs["start"], attrs["stop"], attrs["step"]
    if stop is None:
        start, stop = 0.0, start
    a = torch.arange(start, stop, step, dtype=torch.float64,
                     device=octx.device).to(_dt(attrs))
    if attrs["repeat"] > 1:
        a = torch.repeat_interleave(a, attrs["repeat"])
    return (a,)


register("_arange", _arange,
         params={"start": Param("float", 0.0), "stop": Param("float", None),
                 "step": Param("float", 1.0), "repeat": Param("int", 1),
                 "dtype": Param("dtype", "float32")}, inputs=())
register("zeros_like", lambda attrs, octx, x: (torch.zeros_like(x),),
         infer_shape=_same_shape_infer)
register("ones_like", lambda attrs, octx, x: (torch.ones_like(x),),
         infer_shape=_same_shape_infer)


# ---------------------------------------------------------------------------
# shape and selection ops Gluon's layers and losses call
# ---------------------------------------------------------------------------


def _reshape_like_infer(attrs, in_shapes):
    return in_shapes, [in_shapes[1]]


register("reshape_like", lambda attrs, octx, x, like: (x.reshape(like.shape),),
         inputs=("lhs", "rhs"), infer_shape=_reshape_like_infer)


def _swapaxes_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    s = list(s)
    a, b = attrs["dim1"] % len(s), attrs["dim2"] % len(s)
    s[a], s[b] = s[b], s[a]
    return in_shapes, [tuple(s)]


register("SwapAxis",
         lambda attrs, octx, x: (x.transpose(attrs["dim1"], attrs["dim2"]),),
         params={"dim1": Param("int", 0), "dim2": Param("int", 0)},
         aliases=("swapaxes",), infer_shape=_swapaxes_infer)


def _where(attrs, octx, cond, x, y):
    return (torch.where(cond != 0, x, y),)


ELEMENTWISE.add("where")
register("where", _where, inputs=("condition", "x", "y"),
         infer_shape=_same_shape_infer)

_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


def _pad(attrs, octx, x):
    """``pad_width`` lists (before, after) for every axis, first axis
    first. torch pads the trailing axes, last axis first: the leading
    axes must have no padding (the reference requires that of the first
    two), and edge / reflect take up to three padded axes."""
    pw = attrs["pad_width"]
    mode = attrs["mode"]
    if mode not in _PAD_MODES:
        raise MXNetError(f"Pad: unknown mode {mode}")
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if len(pairs) != x.ndim:
        raise MXNetError(f"Pad: pad_width has {len(pw)} entries for a "
                         f"{x.ndim}-d input")
    first = next((i for i, p in enumerate(pairs) if p != (0, 0)), x.ndim)
    spec = []
    for lo, hi in reversed(pairs[first:]):
        spec += [lo, hi]
    if not spec:
        return (x.clone(),)
    if mode == "constant":
        return (F.pad(x, spec, value=attrs["constant_value"]),)
    if x.ndim - first > 3 or first == 0:
        raise MXNetError(f"Pad: mode {mode} pads at most the last three "
                         "axes, after one unpadded leading axis")
    return (F.pad(x, spec, mode=_PAD_MODES[mode]),)


def _pad_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    pw = attrs["pad_width"]
    return in_shapes, [tuple(d + pw[2 * i] + pw[2 * i + 1]
                             for i, d in enumerate(s))]


register("Pad", _pad,
         params={"mode": Param("str", "constant"),
                 "pad_width": Param("shape", None, True),
                 "constant_value": Param("float", 0.0)},
         aliases=("pad",), infer_shape=_pad_infer)


def _cumsum(attrs, octx, x):
    dt = torch_dtype(attrs["dtype"]) if attrs["dtype"] else None
    if attrs["axis"] is None:
        return (torch.cumsum(x.reshape(-1), 0, dtype=dt),)
    return (torch.cumsum(x, attrs["axis"], dtype=dt),)


def _cumsum_infer(attrs, in_shapes):
    s = in_shapes[0]
    if s is None:
        return in_shapes, [None]
    if attrs["axis"] is None:
        return in_shapes, [(math.prod(s),)]
    return in_shapes, [tuple(s)]


register("cumsum", _cumsum, params={"axis": Param("int", None),
                                    "dtype": Param("dtype", None)},
         infer_shape=_cumsum_infer, aliases=("_np_cumsum",))


# ---------------------------------------------------------------------------
# loss helpers, activations and scaling
# ---------------------------------------------------------------------------


class _MakeLossT(torch.autograd.Function):
    """make_loss: identity forward, gradient 1 everywhere (the incoming
    cotangent is dropped, as the reference does)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.ones_like(g)


def _smooth_l1(attrs, octx, x):
    s2 = attrs["scalar"] ** 2
    ax = x.abs()
    return (torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2),)


ELEMENTWISE.update({"make_loss", "smooth_l1", "hard_sigmoid"})
register("make_loss", lambda attrs, octx, x: (_MakeLossT.apply(x),),
         infer_shape=_same_shape_infer)
register("smooth_l1", _smooth_l1, params={"scalar": Param("float", 1.0)},
         infer_shape=_same_shape_infer)
register("hard_sigmoid", lambda attrs, octx, x: (torch.clamp(
    attrs["alpha"] * x + attrs["beta"], 0.0, 1.0),),
    params={"alpha": Param("float", 0.2), "beta": Param("float", 0.5)},
    infer_shape=_same_shape_infer)
register("_contrib_div_sqrt_dim", lambda attrs, octx, x: (
    x / torch.sqrt(torch.tensor(float(x.shape[-1]), dtype=x.dtype,
                                device=x.device)),),
    infer_shape=_same_shape_infer)

# ---------------------------------------------------------------------------
# linear algebra (la_op): batched over the leading axes
# ---------------------------------------------------------------------------


def _t2(x, flag):
    return x.transpose(-1, -2) if flag else x


register("_linalg_gemm2", lambda attrs, octx, a, b: (
    attrs["alpha"] * torch.matmul(_t2(a, attrs["transpose_a"]),
                                  _t2(b, attrs["transpose_b"])),),
    params={"transpose_a": Param("bool", False),
            "transpose_b": Param("bool", False),
            "alpha": Param("float", 1.0)},
    inputs=("A", "B"), aliases=("linalg_gemm2",))
register("_linalg_gemm", lambda attrs, octx, a, b, c: (
    attrs["alpha"] * torch.matmul(_t2(a, attrs["transpose_a"]),
                                  _t2(b, attrs["transpose_b"]))
    + attrs["beta"] * c,),
    params={"transpose_a": Param("bool", False),
            "transpose_b": Param("bool", False),
            "alpha": Param("float", 1.0), "beta": Param("float", 1.0)},
    inputs=("A", "B", "C"), aliases=("linalg_gemm",))
register("_linalg_potrf", lambda attrs, octx, a: (torch.linalg.cholesky(a),),
         inputs=("A",), aliases=("linalg_potrf",))


def _linalg_potri(attrs, octx, a):
    # A^-1 from its Cholesky factor L: L^-T L^-1
    li = torch.linalg.inv(a)
    return (torch.matmul(li.transpose(-1, -2), li),)


register("_linalg_potri", _linalg_potri, inputs=("A",),
         aliases=("linalg_potri",))


def _linalg_trsm(attrs, octx, a, b):
    """alpha * op(A)^-1 B (or B op(A)^-1 with ``rightside``), A lower
    triangular, op transposes with ``transpose``; the triangle read is
    the JAX op's in each case."""
    alpha = attrs["alpha"]
    if attrs["rightside"]:
        xt = torch.linalg.solve_triangular(
            a.transpose(-1, -2), b.transpose(-1, -2),
            upper=not attrs["transpose"])
        return (alpha * xt.transpose(-1, -2),)
    if attrs["transpose"]:
        return (alpha * torch.linalg.solve_triangular(
            a.transpose(-1, -2), b, upper=True),)
    return (alpha * torch.linalg.solve_triangular(a, b, upper=False),)


register("_linalg_trsm", _linalg_trsm,
         params={"transpose": Param("bool", False),
                 "rightside": Param("bool", False),
                 "alpha": Param("float", 1.0)},
         inputs=("A", "B"), aliases=("linalg_trsm",))


def _linalg_trmm(attrs, octx, a, b):
    at = _t2(a, attrs["transpose"])
    if attrs["rightside"]:
        return (attrs["alpha"] * torch.matmul(b, at),)
    return (attrs["alpha"] * torch.matmul(at, b),)


register("_linalg_trmm", _linalg_trmm,
         params={"transpose": Param("bool", False),
                 "rightside": Param("bool", False),
                 "alpha": Param("float", 1.0)},
         inputs=("A", "B"), aliases=("linalg_trmm",))
register("_linalg_sumlogdiag", lambda attrs, octx, a: (torch.sum(torch.log(
    torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1),),
    inputs=("A",), aliases=("linalg_sumlogdiag",))


def _linalg_syrk(attrs, octx, a):
    at = a.transpose(-1, -2)
    if attrs["transpose"]:
        return (attrs["alpha"] * torch.matmul(at, a),)
    return (attrs["alpha"] * torch.matmul(a, at),)


register("_linalg_syrk", _linalg_syrk,
         params={"transpose": Param("bool", False),
                 "alpha": Param("float", 1.0)},
         inputs=("A",), aliases=("linalg_syrk",))

# ---------------------------------------------------------------------------
# shape manipulation: slice_like, repeat, tile, reverse, the broadcasts,
# depth_to_space / space_to_depth
# ---------------------------------------------------------------------------


def _slice_like(attrs, octx, x, shape_like):
    axes = attrs["axes"]
    tgt = list(x.shape)
    if not axes:
        axes = tuple(range(min(x.ndim, shape_like.ndim)))
    for a in axes:
        tgt[a % x.ndim] = shape_like.shape[a % shape_like.ndim]
    return (x[tuple(slice(0, t) for t in tgt)],)


register("slice_like", _slice_like, params={"axes": Param("shape", ())},
         inputs=("data", "shape_like"))
register("repeat", lambda attrs, octx, x: (torch.repeat_interleave(
    x, attrs["repeats"], dim=attrs["axis"]),),
    params={"repeats": Param("int", None, True), "axis": Param("int", None)})
register("tile", lambda attrs, octx, x: (torch.tile(x, attrs["reps"]),),
         params={"reps": Param("shape", None, True)})
register("reverse", lambda attrs, octx, x: (torch.flip(
    x, tuple(attrs["axis"])),),
    params={"axis": Param("shape", None, True)}, aliases=("flip",))


def _broadcast_axis(attrs, octx, x):
    tgt = list(x.shape)
    for a, s in zip(attrs["axis"], attrs["size"]):
        tgt[a] = s
    return (x.expand(*tgt),)


register("broadcast_axis", _broadcast_axis,
         params={"axis": Param("shape", None, True),
                 "size": Param("shape", None, True)},
         aliases=("broadcast_axes",))
register("broadcast_like", lambda attrs, octx, x, like: (
    x.expand(*like.shape),), inputs=("lhs", "rhs"),
    infer_shape=lambda attrs, s: (s, [s[1]]))


def _depth_to_space(attrs, octx, x):
    b = attrs["block_size"]
    n, c, h, w = x.shape
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return (y.reshape(n, c // (b * b), h * b, w * b),)


def _space_to_depth(attrs, octx, x):
    b = attrs["block_size"]
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return (y.reshape(n, c * b * b, h // b, w // b),)


register("depth_to_space", _depth_to_space,
         params={"block_size": Param("int", None, True)})
register("space_to_depth", _space_to_depth,
         params={"block_size": Param("int", None, True)})

# ---------------------------------------------------------------------------
# indexing: batch_take, gather_nd, scatter_nd, diag, _eye
# ---------------------------------------------------------------------------

register("batch_take", lambda attrs, octx, data, indices: (torch.gather(
    data, 1, indices.to(torch.int64)[:, None])[:, 0],),
    inputs=("a", "indices"))


def _gather_nd(attrs, octx, data, indices):
    idx = indices.to(torch.int64)
    return (data[tuple(idx[i] for i in range(idx.shape[0]))],)


def _scatter_nd(attrs, octx, data, indices):
    idx = indices.to(torch.int64)
    out = torch.zeros(attrs["shape"], dtype=data.dtype, device=data.device)
    return (out.index_put(tuple(idx[i] for i in range(idx.shape[0])),
                          data),)


register("gather_nd", _gather_nd, inputs=("data", "indices"))
register("scatter_nd", _scatter_nd,
         params={"shape": Param("shape", None, True)},
         inputs=("data", "indices"))


def _diag(attrs, octx, x):
    k = attrs["k"]
    if x.ndim == 1:
        return (torch.diag(x, k),)
    return (torch.diagonal(x, offset=k, dim1=-2, dim2=-1),)


register("diag", _diag, params={"k": Param("int", 0)})


def _eye(attrs, octx):
    n = attrs["N"]
    m = attrs["M"] or n
    i = torch.arange(n, device=octx.device)[:, None]
    j = torch.arange(m, device=octx.device)[None, :]
    return ((j - i == attrs["k"]).to(_dt(attrs)),)


register("_eye", _eye, params={"N": Param("int", None, True),
                               "M": Param("int", 0), "k": Param("int", 0),
                               "dtype": Param("dtype", "float32")},
         inputs=())

# ---------------------------------------------------------------------------
# ordering: sort, argsort, topk (stable: equal values keep their order, as
# jnp.argsort and lax.top_k do; a descending order is the ascending one
# reversed, as in the JAX ops)
# ---------------------------------------------------------------------------


def _sort(attrs, octx, x):
    ax = attrs["axis"]
    if ax is None:
        x, ax = x.reshape(-1), 0
    y = torch.sort(x, dim=ax, stable=True).values
    return (y if attrs["is_ascend"] else torch.flip(y, (ax,)),)


def _argsort(attrs, octx, x):
    ax = attrs["axis"]
    if ax is None:
        x, ax = x.reshape(-1), 0
    y = torch.argsort(x, dim=ax, stable=True)
    if not attrs["is_ascend"]:
        y = torch.flip(y, (ax,))
    return (y.to(_dt(attrs)),)


def _topk(attrs, octx, x):
    ax = attrs["axis"]
    k = attrs["k"]
    ret = attrs["ret_typ"]
    if ax is None:
        x2, ax2 = x.reshape(-1), 0
    else:
        x2, ax2 = x, ax % x.ndim
    xm = torch.movedim(x2, ax2, -1)
    # lax.top_k: the k largest, equal values by ascending index (of -x
    # for is_ascend)
    order = torch.sort(xm, dim=-1, descending=not attrs["is_ascend"],
                       stable=True).indices[..., :k]
    vals = torch.movedim(torch.gather(xm, -1, order), -1, ax2)
    idxs = torch.movedim(order, -1, ax2)
    if ret == "value":
        return (vals,)
    if ret == "both":
        return (vals, idxs.to(_dt(attrs)))
    if ret == "mask":
        oh = F.one_hot(idxs, xm.shape[-1]).to(x.dtype).sum(dim=-2)
        return (torch.movedim(oh, -1, ax2) if ax is not None else oh,)
    return (idxs.to(_dt(attrs)),)


register("sort", _sort, params={"axis": Param("int", -1),
                                "is_ascend": Param("bool", True)})
register("argsort", _argsort, params={"axis": Param("int", -1),
                                      "is_ascend": Param("bool", True),
                                      "dtype": Param("dtype", "float32")})
_topk_schema = register("topk", _topk,
                        params={"axis": Param("int", -1),
                                "k": Param("int", 1),
                                "ret_typ": Param("str", "indices"),
                                "is_ascend": Param("bool", False),
                                "dtype": Param("dtype", "float32")})
_topk_schema.num_outputs = lambda attrs: 2 if attrs["ret_typ"] == "both" \
    else 1

# shape-only ops: int64, the reference's dtype
register("shape_array", lambda attrs, octx, x: (torch.tensor(
    tuple(x.shape), dtype=torch.int64, device=x.device),),
    infer_shape=lambda attrs, s: (s, [None if s[0] is None
                                      else (len(s[0]),)]))
register("size_array", lambda attrs, octx, x: (torch.tensor(
    [x.numel()], dtype=torch.int64, device=x.device),),
    infer_shape=lambda attrs, s: (s, [(1,)]))
