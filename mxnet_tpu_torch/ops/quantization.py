"""Weight-only int8/fp8 quantization and the fused-dequant matmul.

Counterpart of the weight-only part of mxnet_tpu/ops/quantization.py
(the legacy activation-quantized ops wait for a later slice):

* :func:`quantize_rows` / :func:`dequantize_rows` — per-output-channel
  symmetric quantization, byte-equal to the JAX package's for int8 and
  for fp8 (``torch.float8_e4m3fn``).
* :func:`quantized_matmul` — ``x @ (q widened) * scale`` without the wide
  weight ever existing. Kernels: ``csrc/quantized_matmul.cu``; plain
  version: :func:`reference_quantized_matmul`. A CPU tensor runs the plain
  version, a CUDA tensor a kernel (or raises). The kernels take float32
  or bfloat16 activations and return x's dtype, as the JAX function does.
  :func:`_qmm_route` picks one of two kernels by shape: ``qmm_small``
  (decode, M <= 16: the narrow weight streamed by cp.async at HBM rate,
  K split over a thread-block cluster) or ``qmm_tc`` (prefill: 128 x 128
  output tiles). Both multiply on the bf16 tensor cores, float32 x as an
  exact three-piece split, so every product is exact. Each call is one
  launch; the ``launches`` counter is raised where it launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..base import MXNetError

__all__ = ["quantize_rows", "dequantize_rows", "quantized_matmul",
           "reference_quantized_matmul", "WEIGHT_QDTYPES"]

WEIGHT_QDTYPES = ("int8", "fp8")
_KIND = {torch.int8: 0, torch.float8_e4m3fn: 1}
_XDTYPE = {torch.float32: 0, torch.bfloat16: 1}
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
    float32 x or K % 8 for bfloat16, every pointer 16-byte aligned). The
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
        raise MXNetError("quantized_matmul: the kernels take float32 or "
                         f"bfloat16 x and float32 scale, got {x.dtype} and "
                         f"{scale.dtype}")
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

    x: (..., K) float32 or bfloat16 activations; q: (K, N) int8 or
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
