"""INT8 quantization: the legacy activation-quantized ops, weight-only
int8/fp8 quantization and the fused-dequant matmul.

Counterpart of mxnet_tpu/ops/quantization.py.

* The seven registered ops of the reference's int8 graph
  (``_contrib_quantize``, ``_contrib_dequantize``, ``_contrib_requantize``,
  ``_contrib_quantized_conv``, ``_contrib_quantized_fully_connected``,
  ``_contrib_quantized_pooling``, ``_contrib_quantized_flatten``), with
  the JAX package's attrs, shape and type rules and range math. The JAX
  package multiplies int8 x int8 into exact int32 sums on the MXU; here
  the products run in float64 (cuDNN's and cuBLAS's double kernels on the
  card, ATen's on the host) and are rounded to int32. Every product and
  partial sum is an integer far below 2^53, so float64 holds each of them
  exactly, in any summation order, and the int32 outputs are the JAX
  package's bit for bit on either device (float32 would not: its sums
  are exact only below 2^24, which a 3 x 3 convolution over 128 int8
  channels passes). The range scalars are computed in float32 as the
  JAX package does, dividing by device tensors: a CUDA division by a
  host scalar multiplies by its reciprocal instead.
* :func:`quantize_rows` / :func:`dequantize_rows` — per-output-channel
  symmetric quantization, byte-equal to the JAX package's for int8 and
  for fp8 (``torch.float8_e4m3fn``).
* :func:`quantized_matmul` — ``x @ (q widened) * scale`` without the wide
  weight ever existing. Kernels: ``csrc/quantized_matmul.cu``; plain
  version: :func:`reference_quantized_matmul`. A CPU tensor runs the plain
  version, a CUDA tensor a kernel (or raises). The kernels take float32,
  bfloat16 or float16 activations and return x's dtype, as the JAX
  function does.
  :func:`_qmm_route` picks one of two kernels by shape: ``qmm_small``
  (decode, M <= 16: the narrow weight streamed by cp.async at HBM rate,
  K split over a thread-block cluster) or ``qmm_tc`` (prefill: 128 x 128
  output tiles). Both multiply on the bf16 tensor cores (float16 x on the
  f16 ones, where every int8 and e4m3 weight is exact), float32 x as an
  exact three-piece split, so every product is exact. Each call is one
  launch; the ``launches`` counter is raised where it launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..base import MXNetError
from .registry import Param, register

__all__ = ["quantize_rows", "dequantize_rows", "quantized_matmul",
           "reference_quantized_matmul", "WEIGHT_QDTYPES"]

WEIGHT_QDTYPES = ("int8", "fp8")
_KIND = {torch.int8: 0, torch.float8_e4m3fn: 1}
_XDTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the decode step's rows (slots) at most, for the weight-streaming kernel
SMALL_M = 16


def _as_tensor(w):
    if isinstance(w, torch.Tensor):
        return w
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w)))


def quantize_rows(w, dtype="int8"):
    """Per-output-channel symmetric weight quantization.

    w: (..., K, N) float array or tensor; the LAST axis is the
    output-feature axis. Returns (q, scale) tensors on w's device: q is
    int8 (or float8_e4m3fn) with w's shape, scale (N,) float32 with
    w ~= q.float() * scale. All-zero channels get scale 1.0. int8 rounds
    half to even and clips to +-127, as ``np.rint`` does in the JAX
    package."""
    w = _as_tensor(w).float()
    if w.ndim < 2:
        raise MXNetError("quantize_rows: need a matrix (ndim >= 2), got "
                         f"shape {tuple(w.shape)}")
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    one = torch.ones_like(amax)
    if dtype == "int8":
        scale = torch.where(amax > 0, amax / 127.0, one)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    elif dtype == "fp8":
        # e4m3fn max finite value is 448
        scale = torch.where(amax > 0, amax / 448.0, one)
        q = (w / scale).to(torch.float8_e4m3fn)
    else:
        raise MXNetError(f"quantize_rows: dtype must be one of "
                         f"{WEIGHT_QDTYPES}, got {dtype!r}")
    return q, scale


def dequantize_rows(q, scale):
    """Inverse of quantize_rows: wide float32 weights."""
    return _as_tensor(q).float() * _as_tensor(scale).float()


def reference_quantized_matmul(x, q, scale):
    """Plain version: ``(x @ q.to(f32)) * scale`` with an f32 product,
    rounded to x's dtype once at the end, the JAX package's XLA spelling
    (``preferred_element_type=f32``)."""
    out = torch.matmul(x.float(), q.float())
    return (out * scale.float()).to(x.dtype)


def _qmm_route(x, q, out):
    """0: ``qmm_small`` (M <= SMALL_M, or a shape the tensor-core kernel
    does not take); 1: ``qmm_tc`` (M > SMALL_M, N % 16 == 0, K % 4 for
    float32 x or K % 8 for bfloat16 / float16, every pointer 16-byte
    aligned). The
    choice rests on shapes and addresses alone."""
    m, k = x.shape
    n = q.shape[1]
    if m <= SMALL_M or n % 16 or k % (4 if x.dtype == torch.float32 else 8):
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (x, q, out)))


def _qmm_kernel(x, q, scale):
    m, k = x.shape
    n = q.shape[1]
    for t, name in ((x, "x"), (q, "q"), (scale, "scale")):
        if not t.is_cuda or t.device != x.device:
            raise MXNetError(f"quantized_matmul: {name} must be on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise MXNetError(f"quantized_matmul: {name} must be contiguous")
    if x.dtype not in _XDTYPE or scale.dtype != torch.float32:
        raise MXNetError("quantized_matmul: the kernels take float32, "
                         "bfloat16 or float16 x and float32 scale, got "
                         f"{x.dtype} and {scale.dtype}")
    if q.dtype not in _KIND:
        raise MXNetError("quantized_matmul: weights must be int8 or "
                         f"float8_e4m3fn, got {q.dtype}")
    if scale.shape != (n,):
        raise MXNetError(f"quantized_matmul: scale {tuple(scale.shape)} "
                         f"for N={n}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    route = _qmm_route(x, q, out)
    if (max(m, n, k) >= 2 ** 31 or (m + SMALL_M - 1) // SMALL_M > 65535
            or (route == 0 and n >= 2 ** 27)):
        raise MXNetError(f"quantized_matmul: shape ({m}, {k}) x ({k}, {n}) "
                         "out of the kernels' range")
    if m == 0 or n == 0:
        return out
    fn = _build.bind("quantized_matmul", "mxt_quantized_matmul",
                     *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 7,
                     ctypes.c_void_p)
    err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
             ctypes.c_void_p(scale.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), m, n, k, _KIND[q.dtype],
             _XDTYPE[x.dtype], route, x.device.index,
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    quantized_matmul.launches += 1
    _build.check(err, "quantized_matmul", "quantized_matmul")
    return out


def quantized_matmul(x, q, scale):
    """x @ dequant(q, scale) without materializing the wide weight.

    x: (..., K) float32, bfloat16 or float16 activations; q: (K, N) int8 or
    float8_e4m3fn; scale: (N,) float32; the result has x's dtype.
    Replaces the TPU kernel mxnet_tpu/ops/quantization.py:_qmm_kernel
    (launched by _qmm_pallas). Any M, N and K: the kernels mask ragged
    edges (the vocab projection has N = 50257)."""
    if q.ndim != 2 or x.shape[-1] != q.shape[0]:
        raise MXNetError(f"quantized_matmul: x {tuple(x.shape)} @ q "
                         f"{tuple(q.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = reference_quantized_matmul(x2, q, scale)
    else:
        out = _qmm_kernel(x2, q, scale)
    return out.reshape(*lead, q.shape[1])


quantized_matmul.launches = 0


# -- the legacy int8 graph's ops (quantize_graph_pass's targets) -------------

_INT32_MAX = float(2 ** 31 - 1)


def _dev(x, v):
    """``v`` as a float32 scalar tensor on ``x``'s device (divisions by it
    are true divisions on the card, as in the JAX package)."""
    return torch.tensor(v, dtype=torch.float32, device=x.device)


def _scalar(t):
    return t.reshape(()).float()


def _float_to_quantized(x, real_range, qrange):
    """Symmetric quantization (quantization_utils.h FloatToQuantized):
    sign(x) * min(|x| * scale + 0.5, qrange), in float32."""
    scale = _dev(x, qrange) / real_range
    return torch.sign(x) * torch.clamp(x.abs() * scale + 0.5, max=qrange)


def _quantize(attrs, octx, data, min_range, max_range):
    ot = attrs["out_type"]
    mn, mx = _scalar(min_range), _scalar(max_range)
    data = data.float()
    if ot == "int8":
        real = torch.maximum(mn.abs(), mx.abs())
        q = torch.trunc(_float_to_quantized(data, real, 127.0))
        return q.to(torch.int8), -real, real
    if ot == "uint8":
        # affine uint8 (quantize-inl.h uint8 lane)
        scale = _dev(data, 255.0) / (mx - mn)
        q = torch.clamp((data - mn) * scale + 0.5, 0.0, 255.0)
        return torch.trunc(q).to(torch.uint8), mn, mx
    raise MXNetError(f"quantize: unsupported out_type {ot!r}")


def _quantize_infer(attrs, in_shapes):
    ds = in_shapes[0]
    return [ds, (1,), (1,)], [ds, (1,), (1,)]


register("_contrib_quantize", _quantize,
         params={"out_type": Param("str", "int8")},
         inputs=("data", "min_range", "max_range"), num_outputs=3,
         infer_shape=_quantize_infer)


def _dequantize(attrs, octx, data, min_range, max_range):
    mn, mx = _scalar(min_range), _scalar(max_range)
    real = torch.maximum(mn.abs(), mx.abs())
    if data.dtype == torch.uint8:
        scale = (mx - mn) / _dev(data, 255.0)
        return (data.float() * scale + mn,)
    qrange = 127.0 if data.dtype == torch.int8 else _INT32_MAX
    return (data.float() * (real / _dev(data, qrange)),)


def _dequantize_infer(attrs, in_shapes):
    ds = in_shapes[0]
    return [ds, (1,), (1,)], [ds]


register("_contrib_dequantize", _dequantize,
         params={"out_type": Param("str", "float32")},
         inputs=("data", "min_range", "max_range"),
         infer_shape=_dequantize_infer,
         infer_type=lambda attrs, in_types: ["float32"])


def _requantize(attrs, octx, data, min_range, max_range):
    """int32 -> int8. With calibrated ranges: a fixed rescale. Without:
    the output range is the data's own |max| (requantize-inl.h online
    mode)."""
    mn, mx = _scalar(min_range), _scalar(max_range)
    in_real = torch.maximum(mn.abs(), mx.abs())
    f = data.float() * (in_real / _dev(data, _INT32_MAX))
    lo, hi = attrs["min_calib_range"], attrs["max_calib_range"]
    if lo is not None and hi is not None:
        out_real = _dev(data, max(abs(lo), abs(hi)))
    else:
        out_real = torch.clamp(f.abs().max(), min=1e-20)
    q = torch.trunc(_float_to_quantized(f, out_real, 127.0))
    return q.to(torch.int8), -out_real, out_real


def _requantize_infer(attrs, in_shapes):
    ds = in_shapes[0]
    return [ds, (1,), (1,)], [ds, (1,), (1,)]


register("_contrib_requantize", _requantize,
         params={"min_calib_range": Param("float", None),
                 "max_calib_range": Param("float", None)},
         inputs=("data", "min_range", "max_range"), num_outputs=3,
         infer_shape=_requantize_infer,
         infer_type=lambda attrs, in_types: ["int8", "float32", "float32"])


def _mult_range(min_a, max_a, min_b, max_b, qa=127.0, qb=127.0):
    """Output range of int8 x int8 -> int32
    (QuantizationRangeForMultiplication, quantization_utils.h:138)."""
    a_level = torch.maximum(min_a.abs(), max_a.abs()) / _dev(min_a, qa)
    b_level = torch.maximum(min_b.abs(), max_b.abs()) / _dev(min_b, qb)
    c_level = a_level * b_level
    top = _dev(min_a, _INT32_MAX)
    return -c_level * top, c_level * top


def _bias_to_int32(bias, min_bias, max_bias, out_level):
    """Fold an int8 bias into the int32 accumulator's scale (round half to
    even, as jnp.round)."""
    b_real = torch.maximum(_scalar(min_bias).abs(), _scalar(max_bias).abs())
    f = bias.float() * (b_real / _dev(bias, 127.0))
    return torch.round(f / out_level).to(torch.int32)


def _exact_int32(y):
    """An integer-valued float64 result as int32: rounded first, since a
    cuDNN algorithm (Winograd, FFT) may leave a residue far below 0.5."""
    return torch.round(y).to(torch.int32)


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _split_qlinear(attrs, rest):
    if attrs["no_bias"]:
        min_d, max_d, min_w, max_w = rest
        return None, min_d, max_d, min_w, max_w, None, None
    return rest


def _quantized_conv(attrs, octx, data, weight, *rest):
    bias, min_d, max_d, min_w, max_w, min_b, max_b = \
        _split_qlinear(attrs, rest)
    ns = len(attrs["kernel"])
    stride = tuple(attrs["stride"] or (1,) * ns)
    dilate = tuple(attrs["dilate"] or (1,) * ns)
    pad = tuple(attrs["pad"] or (0,) * ns)
    # int8 values in float64: exact products and sums (module docstring)
    out = _exact_int32(_CONV[ns](
        data.to(torch.int8).double(), weight.to(torch.int8).double(), None,
        stride, pad, dilate, attrs["num_group"]))
    min_o, max_o = _mult_range(_scalar(min_d), _scalar(max_d),
                               _scalar(min_w), _scalar(max_w))
    if bias is not None:
        out_level = max_o / _dev(max_o, _INT32_MAX)
        b32 = _bias_to_int32(bias, min_b, max_b, out_level)
        out = out + b32.reshape((1, -1) + (1,) * ns)
    return out, min_o, max_o


def _qlinear_inputs(attrs):
    """Input names shared by quantized conv and FC (quantized_conv.cc:120,
    quantized_fully_connected.cc:95): data/weight[/bias] + their ranges."""
    if attrs["no_bias"]:
        return ["data", "weight", "min_data", "max_data", "min_weight",
                "max_weight"]
    return ["data", "weight", "bias", "min_data", "max_data", "min_weight",
            "max_weight", "min_bias", "max_bias"]


def _qconv_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None, (1,), (1,)]
    nf = attrs["num_filter"]
    k = attrs["kernel"]
    ns = len(k)
    stride = tuple(attrs["stride"] or (1,) * ns)
    dilate = tuple(attrs["dilate"] or (1,) * ns)
    pad = tuple(attrs["pad"] or (0,) * ns)
    in_shapes = list(in_shapes)
    if in_shapes[1] is None:
        in_shapes[1] = (nf, ds[1] // attrs["num_group"]) + tuple(k)
    for i, nm in enumerate(_qlinear_inputs(attrs)):
        if i >= 2 and in_shapes[i] is None:
            in_shapes[i] = (nf,) if nm == "bias" else (1,)
    spatial = tuple((d + 2 * p - (dl * (kk - 1) + 1)) // s + 1
                    for d, kk, s, p, dl in zip(ds[2:], k, stride, pad,
                                               dilate))
    return in_shapes, [(ds[0], nf) + spatial, (1,), (1,)]


_QLINEAR_INPUTS = ("data", "weight", "bias", "min_data", "max_data",
                   "min_weight", "max_weight", "min_bias", "max_bias")

_qconv_schema = register(
    "_contrib_quantized_conv", _quantized_conv,
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
    inputs=_QLINEAR_INPUTS, num_outputs=3, infer_shape=_qconv_infer,
    infer_type=lambda attrs, in_types: ["int32", "float32", "float32"])
_qconv_schema.list_inputs = _qlinear_inputs
_qconv_schema.num_inputs = lambda attrs: len(_qlinear_inputs(attrs))


def _quantized_fc(attrs, octx, data, weight, *rest):
    bias, min_d, max_d, min_w, max_w, min_b, max_b = \
        _split_qlinear(attrs, rest)
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = _exact_int32(torch.matmul(x.to(torch.int8).double(),
                                    weight.to(torch.int8).double().t()))
    min_o, max_o = _mult_range(_scalar(min_d), _scalar(max_d),
                               _scalar(min_w), _scalar(max_w))
    if bias is not None:
        out_level = max_o / _dev(max_o, _INT32_MAX)
        out = out + _bias_to_int32(bias, min_b, max_b, out_level)
    return out, min_o, max_o


def _qfc_infer(attrs, in_shapes):
    ds = in_shapes[0]
    nh = attrs["num_hidden"]
    if ds is None:
        return in_shapes, [None, (1,), (1,)]
    in_shapes = list(in_shapes)
    if in_shapes[1] is None:
        in_dim = 1
        for d in ds[1:]:
            in_dim *= d
        in_shapes[1] = (nh, in_dim if attrs["flatten"] else ds[-1])
    for i, nm in enumerate(_qlinear_inputs(attrs)):
        if i >= 2 and in_shapes[i] is None:
            in_shapes[i] = (nh,) if nm == "bias" else (1,)
    out = (ds[0], nh) if attrs["flatten"] else tuple(ds[:-1]) + (nh,)
    return in_shapes, [out, (1,), (1,)]


_qfc_schema = register(
    "_contrib_quantized_fully_connected", _quantized_fc,
    params={"num_hidden": Param("int", None, True),
            "no_bias": Param("bool", False),
            "flatten": Param("bool", True)},
    inputs=_QLINEAR_INPUTS, num_outputs=3, infer_shape=_qfc_infer,
    infer_type=lambda attrs, in_types: ["int32", "float32", "float32"])
_qfc_schema.list_inputs = _qlinear_inputs
_qfc_schema.num_inputs = lambda attrs: len(_qlinear_inputs(attrs))


def _quantized_pooling(attrs, octx, data, min_data, max_data):
    """Pool the integers, back to int8: max pooling is exact; average
    pooling rounds (half to even). The pooling runs in float64, where
    the window sums are exact and the mean is rounded once: the JAX
    package's float32 mean rounds to the same integer, since a mean of
    int8 values lies at least 1 / (2 * window) from any half-integer it
    is not equal to."""
    from .nn import _pooling
    f = _pooling(attrs, octx, data.double())[0]
    if attrs["pool_type"] == "avg":
        f = torch.round(f)
    q = torch.clamp(f, -127, 127).to(torch.int8)
    return q, _scalar(min_data), _scalar(max_data)


def _qpool_infer(attrs, in_shapes):
    from .nn import _pool_infer
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None, (1,), (1,)]
    _, outs = _pool_infer(attrs, [ds])
    return [ds, (1,), (1,)], [outs[0], (1,), (1,)]


register("_contrib_quantized_pooling", _quantized_pooling,
         params={"kernel": Param("shape", ()),
                 "pool_type": Param("str", "max"),
                 "global_pool": Param("bool", False),
                 "stride": Param("shape", None),
                 "pad": Param("shape", None),
                 "pooling_convention": Param("str", "valid"),
                 "count_include_pad": Param("bool", True),
                 "cudnn_off": Param("bool", False)},
         inputs=("data", "min_data", "max_data"), num_outputs=3,
         infer_shape=_qpool_infer,
         infer_type=lambda attrs, in_types: ["int8", "float32", "float32"])


def _quantized_flatten(attrs, octx, data, min_data, max_data):
    return (data.reshape(data.shape[0], -1), _scalar(min_data),
            _scalar(max_data))


def _qflatten_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None, (1,), (1,)]
    flat = 1
    for d in ds[1:]:
        flat *= d
    return [ds, (1,), (1,)], [(ds[0], flat), (1,), (1,)]


register("_contrib_quantized_flatten", _quantized_flatten,
         inputs=("data", "min_data", "max_data"), num_outputs=3,
         infer_shape=_qflatten_infer,
         infer_type=lambda attrs, in_types: [in_types[0], "float32",
                                             "float32"])
