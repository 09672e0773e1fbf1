"""Fused 1x1 convolution with a BN prologue and a BN-statistics epilogue.

Counterpart of mxnet_tpu/ops/conv_fused.py, with its layout and
semantics:

* :func:`conv1x1` — ``y = w @ f(x)`` per image, x (N, Ci, P = H*W),
  w (Co, Ci), y (N, Co, P) in x's dtype. With ``bn_in=(scale, shift)``
  the prologue is ``f(x) = x * scale + shift (+ residual)``, then ReLU
  when ``relu_in``, computed in float32 and rounded back to x's dtype
  before the product (without ``bn_in`` there is no prologue: residual
  and relu_in are ignored, as in the JAX function). The product sums in
  float32. With ``want_stats`` it also returns the per-channel sum and
  sum of squares of the STORED (rounded) y, in float32.
  Kernel: ``csrc/conv1x1.cu``; plain version :func:`reference_conv1x1`.
* :func:`finalize_stats` and :func:`bn_fold` — batch mean, biased
  variance (clamped at 0) and rstd; the folded (scale, shift) of BN-apply.
* :func:`eligible` — the shapes the JAX package's kernel accepts; where
  it raises (``spatial dim ... not blockable``, its VMEM budget) so does
  :func:`conv1x1`, so both packages accept the same calls.

x, w and the residual are float32, bfloat16 or float16 each, every pair
the JAX function takes (a mixed pair keeps both sides' values, as JAX
promotes it to f32: the kernel forms each product exactly, from exact
bf16 pieces of the wider or the other half type); y has x's dtype. A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises. The wrapper's ``launches`` counter is raised exactly where the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["conv1x1", "reference_conv1x1", "finalize_stats", "bn_fold",
           "eligible"]

_BLOCK_P = 512          # the JAX kernel's lane block (multiple of 128)
# the element types of csrc/conv1x1.cu, by its codes (MXT_F32/BF16/F16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _pick_block_p(p, ci, co, has_residual=False):
    """The JAX kernel's spatial block: a multiple of 128 dividing P, else
    all of P when the (Ci + Co, P) working set fits its 8 MiB VMEM budget;
    None when neither does (the JAX function then raises)."""
    if p % 128 == 0:
        for b in (_BLOCK_P, 256, 128):
            if p % b == 0:
                return b
    vmem = (ci * p + co * p) * 2 + co * p * 4
    if has_residual:
        vmem += ci * p * 2
    return p if vmem <= 8 * 1024 * 1024 else None


def eligible(ci, co, p, has_residual=False):
    """Shapes the JAX package's megakernel path accepts: channel dims
    multiples of 8 and a blockable spatial dim."""
    return (ci % 8 == 0 and co % 8 == 0 and
            _pick_block_p(p, ci, co, has_residual) is not None)


def _prologue(x, bn_in, residual, relu_in):
    if bn_in is None:
        return x
    ci = x.shape[1]
    scale = bn_in[0].float().reshape(1, ci, 1)
    shift = bn_in[1].float().reshape(1, ci, 1)
    xf = x.float() * scale + shift
    if residual is not None:
        xf = xf + residual.float()
    if relu_in:
        xf = torch.clamp_min(xf, 0.0)
    return xf.to(x.dtype)


def reference_conv1x1(x, w, *, bn_in=None, residual=None, relu_in=False,
                      want_stats=True):
    """Plain twin of :func:`conv1x1`: the same prologue and rounding, the
    product in float32 by ``torch.matmul``, statistics of the stored y."""
    xp = _prologue(x, bn_in, residual, relu_in)
    y = torch.matmul(w.float(), xp.float()).to(x.dtype)
    if not want_stats:
        return y
    y32 = y.float()
    return y, (y32.sum(dim=(0, 2)), (y32 * y32).sum(dim=(0, 2)))


def _require(cond, what):
    if not cond:
        raise MXNetError("conv1x1: " + what)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def conv1x1(x, w, *, bn_in=None, residual=None, relu_in=False,
            want_stats=True):
    """Fused 1x1 convolution: ``y`` or ``(y, (sum, sumsq))``.

    Replaces the TPU kernel mxnet_tpu/ops/conv_fused.py:_c1x1_kernel. On
    the card ``csrc/conv1x1.cu`` (one launch: the tensor-core kernel, or
    the FMA kernel for float32 x with float32 w; the per-block statistics
    partials are summed here, as the JAX function sums its own); on the
    CPU :func:`reference_conv1x1`."""
    n, ci, p = x.shape
    co = w.shape[0]
    if _pick_block_p(p, ci, co, has_residual=residual is not None) is None:
        raise ValueError(f"spatial dim {p} not blockable")
    if x.device.type == "cpu":
        return reference_conv1x1(x, w, bn_in=bn_in, residual=residual,
                                 relu_in=relu_in, want_stats=want_stats)
    ts = [x, w] + ([] if residual is None else [residual])
    for t in ts:
        _require(t.is_cuda and t.device == x.device,
                 "tensors must all be on x's card")
        _require(t.dtype in _DTYPES, "the kernel takes float32, bfloat16 "
                 f"or float16, got {t.dtype}")
        _require(t.is_contiguous(), "tensors must be contiguous")
    _require(w.shape == (co, ci), f"w must be (Co, Ci) = (*, {ci}), got "
             f"{tuple(w.shape)}")
    _require(residual is None or residual.shape == x.shape,
             f"residual must be {tuple(x.shape)}")
    scale = shift = None
    if bn_in is not None:
        scale, shift = (t.to(device=x.device, dtype=torch.float32)
                        .reshape(ci).contiguous() for t in bn_in)
    y = torch.empty((n, co, p), dtype=x.dtype, device=x.device)
    codes = _DTYPES[x.dtype], _DTYPES[w.dtype]
    # the positions a block covers, which set the partials' second axis,
    # as the kernels' source states them for the pair
    tile = _build.bind("conv1x1", "mxt_conv1x1_tile", ctypes.c_int,
                       ctypes.c_int)(*codes)
    pt = -(-p // tile)
    part = None
    if want_stats:
        part = torch.empty((n, pt, 2, co), dtype=torch.float32,
                           device=x.device)
    fn = _build.bind("conv1x1", "mxt_conv1x1", *[ctypes.c_void_p] * 7,
                     *[ctypes.c_int] * 10, ctypes.c_void_p)
    err = fn(_ptr(x), _ptr(w), _ptr(scale), _ptr(shift), _ptr(residual),
             _ptr(y), _ptr(part), n, ci, co, p, pt, *codes,
             0 if residual is None else _DTYPES[residual.dtype],
             int(bool(relu_in)), x.device.index,
             ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    conv1x1.launches += 1
    _build.check(err, "conv1x1", "conv1x1")
    if not want_stats:
        return y
    sums = part.sum(dim=(0, 1))
    return y, (sums[0], sums[1])


conv1x1.launches = 0


def finalize_stats(s1, s2, count, eps):
    """(mean, var, rstd) from the sums: the biased variance, as BN's,
    clamped at 0 against cancellation."""
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def bn_fold(gamma, beta, mean, rstd):
    """BN-apply as ``x * scale + shift``: scale = gamma * rstd,
    shift = beta - mean * scale."""
    scale = gamma * rstd
    return scale, beta - mean * scale
