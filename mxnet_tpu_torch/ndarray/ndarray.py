"""NDArray — the imperative array over a ``torch.Tensor`` (counterpart of
mxnet_tpu/ndarray/ndarray.py).

An NDArray wraps one tensor (``_data``) on one device. Ops run through
the op registry (``imperative.invoke``) on the inputs' device; PyTorch's
stream order stands in for the reference's dependency engine, and
``wait_to_read`` synchronises the card. The mutation API writes into the
tensor in place (``x[:] = v``, ``x += y``, ``copyto``), so every holder
of the NDArray sees the new values. ``nd.save`` / ``nd.load`` use the
reference's binary container (``ndarray/container.py``), byte for byte
what the JAX package writes.

Inside ``autograd.record()`` the ops are recorded by torch's autograd:
``attach_grad`` makes the tensor a leaf variable, ``backward`` fills its
``grad`` (:mod:`mxnet_tpu_torch.autograd`).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, dtype_name, to_numpy, torch_dtype
from ..context import Context, cpu, current_context, resolve_device
from ..ops.registry import get_op
from .. import imperative as _imp

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "zeros_like", "ones_like", "concatenate", "save", "load",
           "waitall", "moveaxis"]


def _invoke(name, *inputs, **kwargs):
    out = kwargs.pop("out", None)
    return _imp.invoke(get_op(name), list(inputs), kwargs, out=out)


def _host_dtype(t):
    """numpy dtype of a tensor's type (bfloat16 has none: its name)."""
    name = dtype_name(t.dtype)
    return name if name == "bfloat16" else _np.dtype(name)


class NDArray:
    __slots__ = ("_data", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch.Tensor, got "
                            f"{type(data).__name__}")
        self._data = data

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self):
        return _host_dtype(self._data)

    @property
    def context(self) -> Context:
        return Context.of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return _invoke("transpose", self)

    @property
    def grad(self):
        """The gradient buffer ``attach_grad`` allocated (None without
        one): the values of the last backward ("write") or their sum
        ("add")."""
        g = self._data.grad if self._data.is_leaf else None
        return None if g is None else NDArray(g)

    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable: backwards inside ``record()`` fill
        ``grad`` (see :mod:`mxnet_tpu_torch.autograd`). ``stype`` is
        accepted and the gradient stays dense, as in the JAX package."""
        if stype not in (None, "default", "row_sparse", "csr"):
            raise MXNetError(f"attach_grad: unknown stype {stype!r}")
        from .. import autograd
        autograd.mark_variables([self], [None], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def __repr__(self):
        return f"\n{self.asnumpy()!s}\n<NDArray {self.shape} @{self.context}>"

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element NDArray")
        return bool(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __hash__(self):
        return id(self)

    def __reduce__(self):
        # pickled through the host (Updater.get_states); unpickled on the
        # CPU, and the updater moves states to their weight's device
        return (_from_numpy_reduce, (self.asnumpy(),))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- host transfer ------------------------------------------------------
    def asnumpy(self):
        return to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def copy(self):
        return _invoke("_copy", self)

    def copyto(self, other):
        """A copy on ``other`` (a Context), or the values written into
        ``other`` (an NDArray of the same shape, cast to its dtype)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(
                other.torch_device(), copy=True))
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto: shape {self.shape} into "
                                 f"{other.shape}")
            other._invalidate()
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx: Context):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return _invoke("Cast", self, dtype=dtype_name(dt))

    def detach(self):
        return NDArray(self._data.detach())

    def tostype(self, stype):
        """This array (``"default"``) or a dense-backed sparse view of its
        tensor (``"row_sparse"`` / ``"csr"``, as
        ``sparse.row_sparse_array(x)`` / ``sparse.csr_matrix(x)`` build
        from a dense array)."""
        if stype == "default":
            return self
        from . import sparse
        if stype == "row_sparse":
            return sparse.RowSparseNDArray(self._data)
        if stype == "csr":
            if self.ndim != 2:
                raise MXNetError("tostype('csr') needs a 2-D array")
            return sparse.CSRNDArray(self._data)
        raise MXNetError(f"tostype: unknown stype {stype!r}")

    def _invalidate(self):
        """Called before a write into the tensor: a sparse array drops
        the parts it kept (ndarray/sparse.py)."""

    # -- shape ops ----------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if "shape" in kwargs:
            shape = kwargs["shape"]
        elif len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = shape[0]
        return _invoke("Reshape", self, shape=tuple(shape),
                       reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _invoke("reshape_like", self, other)

    def flatten(self):
        return _invoke("Flatten", self)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", self, axes=axes or ())

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", self, dim1=dim1, dim2=dim2)

    def expand_dims(self, axis):
        return _invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return _invoke("squeeze", self, axis=axis)

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", self, shape=shape)

    def clip(self, a_min, a_max):
        return _invoke("clip", self, a_min=a_min, a_max=a_max)

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def one_hot(self, depth, **kw):
        return _invoke("one_hot", self, depth=depth, **kw)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", self, index, axis=axis, keepdims=keepdims)

    # -- reductions and elementwise -------------------------------------------
    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke("sum", self, axis=axis, keepdims=keepdims,
                       exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke("mean", self, axis=axis, keepdims=keepdims,
                       exclude=exclude)

    def prod(self, axis=None, keepdims=False, exclude=False):
        return _invoke("prod", self, axis=axis, keepdims=keepdims,
                       exclude=exclude)

    def max(self, axis=None, keepdims=False, exclude=False):
        return _invoke("max", self, axis=axis, keepdims=keepdims,
                       exclude=exclude)

    def min(self, axis=None, keepdims=False, exclude=False):
        return _invoke("min", self, axis=axis, keepdims=keepdims,
                       exclude=exclude)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", self, axis=axis, keepdims=keepdims)

    def abs(self):
        return _invoke("abs", self)

    def sqrt(self):
        return _invoke("sqrt", self)

    def square(self):
        return _invoke("square", self)

    def exp(self):
        return _invoke("exp", self)

    def log(self):
        return _invoke("log", self)

    def sigmoid(self):
        return _invoke("sigmoid", self)

    def tanh(self):
        return _invoke("tanh", self)

    def relu(self):
        return _invoke("relu", self)

    def softmax(self, axis=-1):
        return _invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", self, axis=axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", self, other, transpose_a=transpose_a,
                       transpose_b=transpose_b)

    def round(self):
        return _invoke("round", self)

    def floor(self):
        return _invoke("floor", self)

    def ceil(self):
        return _invoke("ceil", self)

    def sign(self):
        return _invoke("sign", self)

    # -- arithmetic ---------------------------------------------------------
    def _binary(self, other, op, scalar_op, rscalar_op=None, reverse=False):
        if isinstance(other, NDArray):
            return _invoke(op, other, self) if reverse \
                else _invoke(op, self, other)
        if isinstance(other, (int, float, bool, _np.generic)):
            name = (rscalar_op or scalar_op) if reverse else scalar_op
            return _invoke(name, self, scalar=float(other))
        if isinstance(other, _np.ndarray):
            return self._binary(array(other, ctx=self.context), op,
                                scalar_op, rscalar_op, reverse)
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar",
                            "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar",
                            "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            "_rpower_scalar", reverse=True)

    def __neg__(self):
        return _invoke("negative", self)

    def __abs__(self):
        return _invoke("abs", self)

    def __eq__(self, o):
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def _inplace(self, other, op, scalar_op):
        res = self._binary(other, op, scalar_op)
        if res is NotImplemented:
            return NotImplemented
        _imp.write_into(self, res._data.to(self._data.dtype))
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_plus_scalar")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_minus_scalar")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, o):
        return self._inplace(o, "broadcast_div", "_div_scalar")

    # -- indexing -----------------------------------------------------------
    @staticmethod
    def _norm_key(key, device):
        if isinstance(key, NDArray):
            return key._data.to(device=device, dtype=torch.int64)
        if isinstance(key, tuple):
            return tuple(NDArray._norm_key(k, device) for k in key)
        if isinstance(key, (list, _np.ndarray)):
            return torch.as_tensor(_np.asarray(key, dtype=_np.int64),
                                   device=device)
        return key

    def __getitem__(self, key):
        """Basic indexing gives a view (as the reference's slices share
        memory), an integer array / NDArray key a gather along axis 0."""
        return NDArray(self._data[self._norm_key(key, self._data.device)])

    def __setitem__(self, key, value):
        self._invalidate()
        key = self._norm_key(key, self._data.device)
        if isinstance(value, NDArray):
            v = value._data
        elif isinstance(value, torch.Tensor):
            v = value
        else:
            v = torch.as_tensor(_np.asarray(value))
        with torch.no_grad():
            self._data[key] = v.to(device=self._data.device,
                                   dtype=self._data.dtype)


def _from_numpy_reduce(arr):
    return array(arr, ctx=cpu(), dtype=arr.dtype)


# ---------------------------------------------------------------------------
# factory functions
# ---------------------------------------------------------------------------

def _device(ctx):
    return resolve_device(ctx if ctx is not None else current_context())


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default: the current context, the card)
    holding a copy of ``source_array``. Python lists and float64 arrays
    become float32 (MXNet's default dtype) unless ``dtype`` says
    otherwise."""
    if isinstance(source_array, NDArray):
        t = source_array._data.detach()
    elif isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        arr = _np.asarray(source_array)
        if dtype is None and arr.dtype == _np.float64:
            arr = arr.astype(_np.float32)
        t = torch.from_numpy(_np.array(arr, copy=True))
    if dtype is None and t.dtype == torch.float64:
        t = t.to(torch.float32)
    dt = torch_dtype(dtype) if dtype is not None else t.dtype
    return NDArray(t.to(device=_device(ctx), dtype=dt, copy=True))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kw):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kw):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kw):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _imp.invoke(get_op("_arange"), [], dict(
        start=start, stop=stop, step=step, repeat=repeat,
        dtype=dtype_name(torch_dtype(dtype))), ctx=ctx)


def zeros_like(x):
    return _invoke("zeros_like", x)


def ones_like(x):
    return _invoke("ones_like", x)


def moveaxis(x, source, destination):
    axes = list(range(x.ndim))
    axes.remove(source % x.ndim)
    axes.insert(destination % x.ndim, source % x.ndim)
    return x.transpose(axes)


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke("Concat", *arrays, num_args=len(arrays), dim=axis)


def waitall():
    """Every queued operation on every card is done (Engine::WaitForAll)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def save(fname, data):
    """Write NDArrays to ``fname`` in the reference's container format:
    a dict keeps its names, a list (or one NDArray) has none."""
    from . import container
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        if not all(isinstance(v, NDArray) for v in data.values()):
            raise TypeError("save: dict values must be NDArrays")
        container.save_container(fname, {k: container.blob_of(v)
                                         for k, v in data.items()})
    elif isinstance(data, (list, tuple)):
        if not all(isinstance(d, NDArray) for d in data):
            raise TypeError("save: list elements must be NDArrays")
        container.save_container(fname, [container.blob_of(d)
                                         for d in data])
    else:
        raise TypeError("save: data must be NDArray, list, or dict")


def load(fname, ctx=None):
    """NDArrays of a container file: a dict when it holds names, else a
    list. They are placed on ``ctx`` (default: the host, as the JAX
    package's default context is); ``Module.set_params`` and the
    initializers copy them to the bound arrays' device."""
    from . import container
    items = container.load_container(fname, sparse=True)
    ctx = ctx if ctx is not None else cpu()

    def nd(v):
        if isinstance(v, container.SparseBlob):
            from . import sparse
            make = sparse.row_sparse_array if v.stype == "row_sparse" \
                else sparse.csr_matrix
            return make(v.parts, shape=v.shape, ctx=ctx)
        return array(v, ctx=ctx, dtype=v.dtype)

    if isinstance(items, dict):
        return {k: nd(v) for k, v in items.items()}
    return [nd(v) for v in items]
