"""Neural-network operators (counterpart of mxnet_tpu/ops/nn.py), in two
forms. The functions at the top take tensors and keyword attrs with the
reference semantics; Gluon's ``hybrid_forward(F, ...)`` receives this
module as ``F``. The registered ops below them (FullyConnected,
Convolution, Pooling, Activation, softmax, log_softmax, SoftmaxOutput,
BatchNorm, Dropout) take ``(attrs, octx, *tensors)`` for the registry,
the executor and ``mx.nd``.

None of these has a Pallas kernel in the JAX package (XLA fuses them
there), so they are plain PyTorch ops here, in full float32: the matrix
products go to ``torch.matmul`` through ``F.linear`` (``allow_tf32``
stays False, PyTorch's default) and the convolutions to cuDNN with TF32
off for each call (``cudnn_f32``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import Param, register

__all__ = ["FullyConnected", "LayerNorm", "Embedding", "Activation",
           "Dropout", "log_softmax", "pick", "cudnn_f32"]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x W^T + b with the reference's weight layout (num_hidden, in).
    ``flatten`` folds every axis after the first into the input width."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, None if no_bias else bias)


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """(x - mean) * rsqrt(var + eps) * gamma + beta over ``axis``, with the
    biased variance."""
    axis = axis % data.ndim
    if axis == data.ndim - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    bshape = [data.shape[axis] if i == axis else 1 for i in range(data.ndim)]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


def Embedding(data, weight, input_dim=None):
    """Rows of ``weight`` at ``data``: float ids are cast to int
    (truncation) and clipped to [0, input_dim - 1], where
    ``torch.embedding`` would raise on an id out of range."""
    n = weight.shape[0] if input_dim is None else int(input_dim)
    idx = data.to(torch.int64).clamp(0, n - 1)
    return F.embedding(idx, weight)


def Activation(x, act_type):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return x / (1 + x.abs())
    raise MXNetError(f"Activation: unknown act_type {act_type}")


def Dropout(x, p=0.5, training=False, generator=None):
    """Inverted dropout: in training mode each element is kept with
    probability 1 - p and scaled by 1 / (1 - p); otherwise x unchanged.
    The mask is drawn from ``generator`` (the port's default generator of
    x's device when None)."""
    if not training or p <= 0:
        return x
    if generator is None:
        from ..random import generator as default_generator
        generator = default_generator(x.device)
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


def log_softmax(x, axis=-1, temperature=1.0):
    z = x / temperature if temperature != 1.0 else x
    return torch.log_softmax(z, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """data[..., index, ...] along ``axis``, index clipped into range."""
    idx = index.to(torch.int64)
    axis = axis % data.ndim
    if idx.ndim < data.ndim:
        idx = idx.unsqueeze(axis)
    idx = idx.clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


# ---------------------------------------------------------------------------
# The symbolic path's operators, registered with the JAX package's names,
# attrs and shape rules (mxnet_tpu/ops/nn.py). Each fcompute takes
# (attrs, octx, *tensors) and returns a tuple.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def cudnn_f32():
    """cuDNN and cuBLAS in full float32 for the enclosed calls: PyTorch
    lets cuDNN convolutions use TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), unlike its matmuls;
    the convolutions' GEMM weight gradient (``_conv_wgrad_gemm``) runs
    inside the same scope. The flags are lowered for the call and
    restored after it, never flipped for the process."""
    cd, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cd.allow_tf32, mm.allow_tf32)
    cd.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cd.allow_tf32, mm.allow_tf32 = old


def _conv_wgrad_gemm(dy, x, w_shape, stride, pad, dilate):
    """A 2-D convolution's weight gradient (groups 1, dilation 1) as one
    float32 GEMM: dW[o, c, i, j] = sum over n, h, w of dy[n, o, h, w] *
    xpad[n, c, h * s + i, w * s + j], the input's windows taken as a
    strided view (``Tensor.unfold``) and contracted by ``tensordot``
    (a copy of each operand into GEMM order, then one product). It keeps
    float32's precision where cuDNN's heuristic may pick a weight-gradient
    algorithm that loses it (``_wgrad_route``)."""
    if dilate != (1, 1):
        raise MXNetError("_conv_wgrad_gemm takes dilation 1")
    xp = F.pad(x, (pad[1], pad[1], pad[0], pad[0])) if any(pad) else x
    win = xp.unfold(2, w_shape[2], stride[0]).unfold(3, w_shape[3],
                                                     stride[1])
    return torch.tensordot(dy, win, dims=([0, 2, 3], [0, 2, 3]))


# cuDNN's float32 weight gradient on the H100 (cuDNN 9.2): at stride 1
# with 5 x 5 kernels its heuristic picks, for some shapes, an algorithm
# that lies 6.8e-4 to 1.6e-2 of the gradient's largest magnitude from
# float64 (LeNet's c1 at batch 8: 6.8e-4; 64 -> 64 channels at 56 x 56,
# batch 128: 1.6e-2), where the GEMM stays within 3.5e-6
# (tools/torch_f32_witness.py --sweep, PERF.md). Which 5 x 5 shapes it
# picks that algorithm for follows no rule the port can see, so every
# float32 stride-1 5 x 5 2-D convolution (groups 1, dilation 1) takes the
# GEMM. 3 x 3 stays on cuDNN: its worst swept error is 4.8e-5, within the
# card test's bound, and the GEMM would cost ResNet-50 ~10 ms a step.
_WGRAD_GEMM_KERNELS = ((5, 5),)


def _wgrad_route(x, w, stride, dilate, groups):
    """"gemm" or "cudnn" for a convolution's weight gradient, from its
    shape and type alone."""
    if (x.dtype == torch.float32 and x.ndim == 4 and groups == 1
            and tuple(w.shape[2:]) in _WGRAD_GEMM_KERNELS
            and tuple(stride) == (1, 1) and tuple(dilate) == (1, 1)):
        return "gemm"
    return "cudnn"


class _BiasAddDead(torch.autograd.Function):
    """y + b whose bias gradient is an exact zero (the JAX package's
    ``_bias_add_dead_grad``): set by the executor's dead-bias pass when
    the op's only consumer is a batch-statistics BatchNorm, which cancels
    any per-channel shift."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b

    @staticmethod
    def backward(ctx, dy):
        return dy, torch.zeros(dy.shape[-1:], dtype=dy.dtype,
                               device=dy.device)


def _fc(attrs, octx, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    if attrs["no_bias"]:
        return (F.linear(x, weight),)
    if attrs.get("__bias_grad_dead__"):
        return (_BiasAddDead.apply(F.linear(x, weight), bias.to(x.dtype)),)
    return (F.linear(x, weight, bias.to(x.dtype)),)


def _fc_infer(attrs, in_shapes):
    ds = in_shapes[0]
    nh = attrs["num_hidden"]
    in_shapes = list(in_shapes)
    if ds is not None and in_shapes[1] is None:
        in_shapes[1] = (nh, math.prod(ds[1:]) if attrs["flatten"]
                        else ds[-1])
    if not attrs["no_bias"] and len(in_shapes) > 2 and in_shapes[2] is None:
        in_shapes[2] = (nh,)
    if ds is None:
        return in_shapes, [None]
    out = (ds[0], nh) if attrs["flatten"] else tuple(ds[:-1]) + (nh,)
    return in_shapes, [out]


def _optional_bias_inputs(attrs):
    return ["data", "weight"] if attrs["no_bias"] \
        else ["data", "weight", "bias"]


_fc_schema = register(
    "FullyConnected", _fc,
    params={"num_hidden": Param("int", None, True),
            "no_bias": Param("bool", False),
            "flatten": Param("bool", True)},
    inputs=("data", "weight", "bias"), infer_shape=_fc_infer)
_fc_schema.list_inputs = _optional_bias_inputs
_fc_schema.num_inputs = lambda attrs: 2 if attrs["no_bias"] else 3

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class _Conv(torch.autograd.Function):
    """Convolution with its forward and backward both in full float32
    (``cudnn_f32``): the backward convolutions run when autograd calls
    them, outside any scope around the forward, so they set the flag
    themselves. The weight gradient of the shapes ``_wgrad_route`` names
    is the GEMM of ``_conv_wgrad_gemm``, not cuDNN's. ``dead_bias``
    returns an exact zero bias gradient without reducing dy."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad, dilate, groups, dead_bias):
        with cudnn_f32():
            y = _CONV[x.ndim - 2](x, w, b, stride, pad, dilate, groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, dilate, groups, b is not None, dead_bias)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, pad, dilate, groups, has_bias, dead_bias = ctx.conf
        need_b = has_bias and not dead_bias and ctx.needs_input_grad[2]
        need_w = ctx.needs_input_grad[1]
        gemm = need_w and _wgrad_route(x, w, stride, dilate,
                                       groups) == "gemm"
        with cudnn_f32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, w, [w.shape[0]] if has_bias else None, list(stride),
                list(pad), list(dilate), False, [0] * len(stride), groups,
                [ctx.needs_input_grad[0], need_w and not gemm, need_b])
            if gemm:
                dw = _conv_wgrad_gemm(dy, x, w.shape, stride, pad, dilate)
        if has_bias and dead_bias:
            db = torch.zeros(w.shape[0], dtype=dy.dtype, device=dy.device)
        return dx, dw, db, None, None, None, None, None


def _conv_attrs(attrs, ns):
    stride = tuple(attrs["stride"] or (1,) * ns)
    dilate = tuple(attrs["dilate"] or (1,) * ns)
    pad = tuple(attrs["pad"] or (0,) * ns)
    return tuple(attrs["kernel"]), stride, dilate, pad


def _conv(attrs, octx, data, weight, bias=None):
    ns = len(attrs["kernel"])
    _, stride, dilate, pad = _conv_attrs(attrs, ns)
    b = None if attrs["no_bias"] else bias.to(data.dtype)
    return (_Conv.apply(data, weight, b, stride, pad, dilate,
                        attrs["num_group"],
                        bool(attrs.get("__bias_grad_dead__"))),)


def _conv_infer(attrs, in_shapes):
    ds = in_shapes[0]
    nf = attrs["num_filter"]
    ns = len(attrs["kernel"])
    k, stride, dilate, pad = _conv_attrs(attrs, ns)
    in_shapes = list(in_shapes)
    if ds is not None and in_shapes[1] is None:
        in_shapes[1] = (nf, ds[1] // attrs["num_group"]) + k
    if not attrs["no_bias"] and len(in_shapes) > 2 and in_shapes[2] is None:
        in_shapes[2] = (nf,)
    if ds is None:
        return in_shapes, [None]
    spatial = tuple((ds[2 + i] + 2 * pad[i] - (dilate[i] * (k[i] - 1) + 1))
                    // stride[i] + 1 for i in range(ns))
    return in_shapes, [(ds[0], nf) + spatial]


_conv_schema = register(
    "Convolution", _conv,
    params={"kernel": Param("shape", None, True),
            "stride": Param("shape", None),
            "dilate": Param("shape", None),
            "pad": Param("shape", None),
            "num_filter": Param("int", None, True),
            "num_group": Param("int", 1),
            "no_bias": Param("bool", False),
            "workspace": Param("int", 1024),
            "cudnn_tune": Param("str", None),
            "cudnn_off": Param("bool", False),
            "layout": Param("str", None)},
    inputs=("data", "weight", "bias"), infer_shape=_conv_infer)
_conv_schema.list_inputs = _optional_bias_inputs
_conv_schema.num_inputs = lambda attrs: 2 if attrs["no_bias"] else 3

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_out(d, k, s, p, full):
    if full:
        return -(-(d + 2 * p - k) // s) + 1
    return (d + 2 * p - k) // s + 1


def _pooling(attrs, octx, data):
    """The JAX package's ``_pooling``: ``full`` is ceil mode with the
    right pad widened until the last window fits (a window that starts in
    the padding is kept, where torch's ``ceil_mode`` drops it), and
    average pooling counts the padding unless ``count_include_pad`` is
    False. torch's own padding serves where it means the same (``valid``
    with pad <= kernel / 2); otherwise the input is padded explicitly
    (-inf for max, 0 for avg/sum) and pooled without padding."""
    ptype = attrs["pool_type"]
    ns = data.ndim - 2
    if ptype not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling: pool_type {ptype!r} is not ported")
    if attrs["global_pool"]:
        dims = tuple(range(2, data.ndim))
        if ptype == "max":
            return (torch.amax(data, dim=dims, keepdim=True),)
        red = torch.mean if ptype == "avg" else torch.sum
        return (red(data, dim=dims, keepdim=True),)
    k = tuple(attrs["kernel"])
    stride = tuple(attrs["stride"] or (1,) * ns)
    pad = tuple(attrs["pad"] or (0,) * ns)
    full = attrs["pooling_convention"] == "full"
    extra = [0] * ns
    if full:
        for i in range(ns):
            d = data.shape[2 + i]
            span = (_pool_out(d, k[i], stride[i], pad[i], True) - 1) \
                * stride[i] + k[i]
            extra[i] = max(0, span - (d + 2 * pad[i]))
    native = not any(extra) and all(p <= kk // 2 for p, kk in zip(pad, k))
    if ptype == "max":
        if native:
            return (_MAXPOOL[ns](data, k, stride, pad),)
        return (_MAXPOOL[ns](_pad_right(data, pad, extra, -math.inf),
                             k, stride),)
    cip = attrs["count_include_pad"]
    if native and ptype == "avg":
        return (_AVGPOOL[ns](data, k, stride, pad, count_include_pad=cip),)
    xp = _pad_right(data, pad, extra, 0.0)
    y = _AVGPOOL[ns](xp, k, stride)
    if ptype == "sum":
        return (y * math.prod(k),)
    if not cip:
        ones = _pad_right(torch.ones((1, 1) + data.shape[2:],
                                     dtype=data.dtype, device=data.device),
                          pad, extra, 0.0)
        y = y / _AVGPOOL[ns](ones, k, stride)
    return (y,)


def _pad_right(x, pad, extra, value):
    """Pad the spatial axes by ``pad`` on both sides plus ``extra`` on
    the right (F.pad lists the last axis first)."""
    spec = []
    for p, e in zip(reversed(pad), reversed(extra)):
        spec += [p, p + e]
    return F.pad(x, spec, value=value)


def _pool_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    if attrs["global_pool"]:
        return in_shapes, [tuple(ds[:2]) + (1,) * (len(ds) - 2)]
    ns = len(ds) - 2
    k = attrs["kernel"]
    stride = tuple(attrs["stride"] or (1,) * ns)
    pad = tuple(attrs["pad"] or (0,) * ns)
    full = attrs["pooling_convention"] == "full"
    return in_shapes, [tuple(ds[:2]) + tuple(
        _pool_out(ds[2 + i], k[i], stride[i], pad[i], full)
        for i in range(ns))]


register("Pooling", _pooling,
         params={"kernel": Param("shape", ()),
                 "pool_type": Param("str", "max"),
                 "global_pool": Param("bool", False),
                 "stride": Param("shape", None),
                 "pad": Param("shape", None),
                 "pooling_convention": Param("str", "valid"),
                 "count_include_pad": Param("bool", True),
                 "cudnn_off": Param("bool", False)},
         infer_shape=_pool_infer)


def _same1(attrs, in_shapes):
    return in_shapes, [in_shapes[0]]


register("Activation",
         lambda attrs, octx, x: (Activation(x, attrs["act_type"]),),
         params={"act_type": Param("str", None, True)}, infer_shape=_same1)


def _softmax(attrs, octx, x):
    t = attrs["temperature"]
    return (torch.softmax(x / t if t != 1.0 else x, dim=attrs["axis"]),)


def _log_softmax(attrs, octx, x):
    return (log_softmax(x, attrs["axis"], attrs["temperature"]),)


register("softmax", _softmax,
         params={"axis": Param("int", -1), "temperature": Param("float", 1.0)},
         infer_shape=_same1)
register("log_softmax", _log_softmax,
         params={"axis": Param("int", -1), "temperature": Param("float", 1.0)},
         infer_shape=_same1)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward (softmax - target), defined through the
    implied cross-entropy loss: the incoming cotangent is dropped, as the
    reference does (src/operator/softmax_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if attrs["multi_output"] else -1
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, _dy):
        out, lbl = ctx.saved_tensors
        a = ctx.attrs
        multi = a["multi_output"]
        axis = 1 if multi else out.ndim - 1
        nclass = out.shape[axis]
        use_ignore = a["use_ignore"]
        if lbl.shape == out.shape:
            tgt = lbl.to(out.dtype)
            valid = torch.ones(lbl.shape[:1], dtype=out.dtype,
                               device=out.device)
            out_m = out
        else:
            li = lbl.to(torch.int64)
            inside = (li >= 0) & (li < nclass)
            oh = F.one_hot(li.clamp(0, nclass - 1), nclass) \
                * inside.unsqueeze(-1)
            oh = oh.to(out.dtype)
            if multi:
                oh = torch.movedim(oh, -1, 1)
            tgt = oh
            smooth = a["smooth_alpha"]
            if smooth:
                tgt = tgt * (1 - smooth) + smooth / (nclass - 1) * (1 - tgt)
            valid = torch.ones(li.shape, dtype=out.dtype, device=out.device)
            out_m = out
            if use_ignore:
                mask = (li != int(a["ignore_label"])).to(out.dtype)
                valid = mask
                m = mask.unsqueeze(1) if multi else mask.unsqueeze(-1)
                tgt = tgt * m
                out_m = out * m
        grad = out_m - tgt
        denom = a.get("__denominator__")
        if denom is not None:            # the whole batch's (a mesh)
            grad = grad / (denom.to(grad.device)
                           if isinstance(denom, torch.Tensor) else denom)
        elif a["normalization"] == "batch":
            grad = grad / out.shape[0]
        elif a["normalization"] == "valid":
            grad = grad / torch.clamp_min(valid.sum(), 1.0)
        grad = grad * a["grad_scale"]
        return grad.to(out.dtype), torch.zeros_like(lbl), None


def _softmax_output(attrs, octx, data, label):
    return (_SoftmaxOutput.apply(data, label, attrs),)


def _softmax_output_mesh(attrs, octx, replicas):
    """SoftmaxOutput over a mesh's replicas: the ``batch`` / ``valid``
    normalisation divides by the whole batch's count, as the JAX package's
    one global array does."""
    norm = attrs["normalization"]
    if norm in ("batch", "valid"):
        attrs = type(attrs)(attrs)
        if norm == "batch":
            attrs["__denominator__"] = float(sum(d.shape[0]
                                                 for d, _ in replicas))
        else:
            dev = replicas[0][0].device
            attrs["__denominator__"] = torch.clamp_min(sum(
                _valid_count(attrs, d, lbl).to(dev)
                for d, lbl in replicas), 1.0)
    return [_softmax_output(attrs, octx, d, lbl) for d, lbl in replicas]


def _valid_count(a, data, lbl):
    """The labels SoftmaxOutput's ``valid`` normalisation counts."""
    if lbl.shape == data.shape:
        return torch.tensor(float(lbl.shape[0]), device=data.device)
    if a["use_ignore"]:
        return (lbl.to(torch.int64) != int(a["ignore_label"])).sum() \
            .to(torch.float32)
    return torch.tensor(float(lbl.numel()), device=data.device)


def _softmax_output_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes = list(in_shapes)
    if ds is not None and in_shapes[1] is None:
        in_shapes[1] = (ds[0],) + tuple(ds[2:]) if attrs["multi_output"] \
            else tuple(ds[:-1])
    return in_shapes, [ds]


register("SoftmaxOutput", _softmax_output,
         params={"grad_scale": Param("float", 1.0),
                 "ignore_label": Param("float", -1.0),
                 "use_ignore": Param("bool", False),
                 "multi_output": Param("bool", False),
                 "preserve_shape": Param("bool", False),
                 "normalization": Param("str", "null"),
                 "out_grad": Param("bool", False),
                 "smooth_alpha": Param("float", 0.0)},
         inputs=("data", "label"), aliases=("Softmax",),
         infer_shape=_softmax_output_infer, fmesh=_softmax_output_mesh)


def _bn_shapes(data, axis):
    red = tuple(i for i in range(data.ndim) if i != axis)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    return red, bshape


def _acc_dtype(data):
    """BatchNorm's statistics type: float32 for float32 and half data (as
    the JAX package), float64 for float64 data."""
    return torch.promote_types(data.dtype, torch.float32)


def _batch_norm(attrs, octx, data, gamma, beta, moving_mean, moving_var):
    eps = attrs["eps"]
    momentum = attrs["momentum"]
    axis = attrs["axis"] % data.ndim
    _, bshape = _bn_shapes(data, axis)
    relu = bool(attrs.get("__fuse_relu__", False))
    if octx.is_train and not attrs["use_global_stats"]:
        out, mean, var = _BNTrain.apply(axis, eps, bool(attrs["fix_gamma"]),
                                        relu, gamma, beta, data)
        with torch.no_grad():
            new_mean = momentum * moving_mean \
                + (1 - momentum) * mean.to(moving_mean.dtype)
            new_var = momentum * moving_var \
                + (1 - momentum) * var.to(moving_var.dtype)
        return (out, new_mean, new_var)
    g = torch.ones_like(gamma) if attrs["fix_gamma"] else gamma
    inv = torch.rsqrt(moving_var.to(_acc_dtype(data)) + eps).to(data.dtype)
    out = (data - moving_mean.reshape(bshape).to(data.dtype)) \
        * inv.reshape(bshape) * g.reshape(bshape).to(data.dtype) \
        + beta.reshape(bshape).to(data.dtype)
    if relu:
        out = torch.relu(out)
    return (out, moving_mean, moving_var)


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm (the JAX package's ``_bn_train``) over one
    batch tensor or over a mesh's replicas, with the whole batch's
    statistics (a synchronised BatchNorm: the JAX package shards one
    global array, so its statistics are the global batch's). Statistics
    are float32 (float64 for float64 data) and two-pass: the sum, then
    the squared deviations from the mean (E[x^2] - mean^2 cancels when
    |mean| >> std). The replicas' partial sums go to the first replica's
    device and are added there, in both passes and in the backward's two
    channel reductions; each replica then normalises, or forms dx, with
    the global values. With ``relu`` (the executor's BN+ReLU fusion) the
    forward applies the ReLU and the backward masks dy by recomputing the
    pre-activation from xhat (g * xhat + beta > 0) instead of saving the
    output: an element exactly on the boundary may round to the other
    side (one ulp of gradient noise, accepted). Inputs (axis, eps,
    fix_gamma, relu, gamma, beta, *data); outputs (*out, mean, var),
    statistics on the first device."""

    @staticmethod
    def forward(ctx, axis, eps, fix_gamma, relu, gamma, beta, *datas):
        dev0 = gamma.device
        red, bshape = _bn_shapes(datas[0], axis)
        acc = _acc_dtype(datas[0])
        count = sum(math.prod(d.shape[i] for i in red) for d in datas)
        mean = _sum_to(dev0, [torch.sum(d, dim=red, dtype=acc)
                              for d in datas]) / count
        var = _sum_to(dev0, [torch.sum(torch.square(
            d.to(acc) - mean.to(d.device).reshape(bshape)), dim=red)
            for d in datas]) / count
        rstd = torch.rsqrt(var + eps)
        gf = (torch.ones_like(gamma) if fix_gamma else gamma).to(acc)
        scale, shift = gf * rstd, beta.to(acc) - mean * gf * rstd
        outs = []
        for d in datas:
            o = d * scale.to(d.device, d.dtype).reshape(bshape) \
                + shift.to(d.device, d.dtype).reshape(bshape)
            outs.append(torch.relu(o) if relu else o)
        ctx.save_for_backward(gamma, beta, mean, rstd, *datas)
        ctx.conf = (axis, fix_gamma, relu, count)
        ctx.mark_non_differentiable(mean, var)
        return (*outs, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        gamma, beta, mean, rstd, *datas = ctx.saved_tensors
        axis, fix_gamma, relu, count = ctx.conf
        dev0 = gamma.device
        red, bshape = _bn_shapes(datas[0], axis)
        acc = _acc_dtype(datas[0])
        g = torch.ones_like(gamma) if fix_gamma else gamma
        xhats, dys = [], []
        for d, dy in zip(datas, grads[:len(datas)]):
            xhat = (d - mean.to(d.device, d.dtype).reshape(bshape)) \
                * rstd.to(d.device, d.dtype).reshape(bshape)
            if relu:
                pre = xhat * g.to(d.device, d.dtype).reshape(bshape) \
                    + beta.to(d.device, d.dtype).reshape(bshape)
                dy = torch.where(pre > 0, dy, torch.zeros(
                    (), dtype=dy.dtype, device=dy.device))
            xhats.append(xhat)
            dys.append(dy)
        dbeta = _sum_to(dev0, [torch.sum(dy, dim=red, dtype=acc)
                               for dy in dys])
        dgamma = _sum_to(dev0, [torch.sum(dy * xh, dim=red, dtype=acc)
                                for dy, xh in zip(dys, xhats)])
        coef = g.to(acc) * rstd
        dxs = []
        for d, dy, xh in zip(datas, dys, xhats):
            c = coef.to(d.device, d.dtype).reshape(bshape)
            dxs.append(c * (dy - (dbeta / count).to(d.device, d.dtype)
                            .reshape(bshape) - xh * (dgamma / count).to(
                                d.device, d.dtype).reshape(bshape)))
        dgamma_out = torch.zeros_like(gamma) if fix_gamma \
            else dgamma.to(gamma.dtype)
        return (None, None, None, None, dgamma_out, dbeta.to(beta.dtype),
                *dxs)


def _sum_to(device, parts):
    """The sum of per-replica tensors, on ``device``, in replica order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _batch_norm_mesh(attrs, octx, replicas):
    """BatchNorm over a mesh's replicas: batch statistics of the whole
    batch (``_BNTrain``) and one moving-statistics update from them, the
    same on every replica; any other mode is per replica."""
    if not (octx.is_train and not attrs["use_global_stats"]):
        return [_batch_norm(attrs, octx, *r) for r in replicas]
    data0, gamma, beta, moving_mean, moving_var = replicas[0]
    res = _BNTrain.apply(attrs["axis"] % data0.ndim, attrs["eps"],
                             bool(attrs["fix_gamma"]),
                             bool(attrs.get("__fuse_relu__", False)),
                             gamma, beta, *[r[0] for r in replicas])
    mean, var = res[-2:]
    momentum = attrs["momentum"]
    with torch.no_grad():
        new_mean = momentum * moving_mean \
            + (1 - momentum) * mean.to(moving_mean.dtype)
        new_var = momentum * moving_var \
            + (1 - momentum) * var.to(moving_var.dtype)
    return [(out, new_mean, new_var) for out in res[:-2]]


def _bn_infer(attrs, in_shapes):
    ds = in_shapes[0]
    in_shapes = list(in_shapes)
    if ds is not None:
        c = (ds[attrs["axis"] % len(ds)],)
        for i in range(1, 5):
            if in_shapes[i] is None:
                in_shapes[i] = c
    return in_shapes, [ds]


register("BatchNorm", _batch_norm,
         params={"eps": Param("float", 1e-3),
                 "momentum": Param("float", 0.9),
                 "fix_gamma": Param("bool", True),
                 "use_global_stats": Param("bool", False),
                 "output_mean_var": Param("bool", False),
                 "axis": Param("int", 1),
                 "cudnn_off": Param("bool", False)},
         inputs=("data", "gamma", "beta", "moving_mean", "moving_var"),
         aux=("moving_mean", "moving_var"), mutates_aux=True,
         infer_shape=_bn_infer, aliases=("BatchNorm_v1",),
         fmesh=_batch_norm_mesh)


def _dropout(attrs, octx, x):
    p = attrs["p"]
    if not ((octx.is_train or attrs["mode"] == "always") and p > 0) \
            or octx.rng is None:
        return (x,)
    if attrs["axes"]:
        raise MXNetError("Dropout: axes (shared masks) are not ported")
    keep = 1.0 - p
    mask = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        .bernoulli_(keep, generator=octx.rng)
    return (torch.where(mask > 0, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device)),)


register("Dropout", _dropout,
         params={"p": Param("float", 0.5), "mode": Param("str", "training"),
                 "axes": Param("shape", None)},
         needs_rng=True, infer_shape=_same1)
