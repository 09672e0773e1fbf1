"""The two hand-written kernels of the two-stage detectors' path, each
beside its plain PyTorch version: ROIPooling (``csrc/roi_pooling.cu``,
forward and backward) and the greedy NMS of Proposal / MultiProposal
(``csrc/proposal_nms.cu``). Neither replaces a TPU kernel: the JAX
package computes both as plain XLA (mxnet_tpu/ops/contrib.py:528 and
:286), which at Faster R-CNN's widths is a 4 GB intermediate a step
(ROIPooling's masked max over the whole map for every roi) and a host
loop of 12,000 rows (the NMS).

A wrapper given CUDA tensors launches its kernel on the current stream
(or raises); host tensors take the plain version, which is also what
the card's kernels are held against. ``roi_pooling.launches`` counts the
forward and backward launches, ``proposal_nms.launches`` the calls (two
kernels each). Neither kernel reads anything back to the host, so a
step that holds them can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["roi_pooling", "roi_pooling_plain", "proposal_nms",
           "proposal_nms_plain"]

_NEG = -1e30
# dtype codes of the two sources
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}
# bytes of the plain ROIPooling's (rois, C, pw, H, W) intermediate a chunk
_PLAIN_CHUNK_BYTES = 256 << 20
# rows of the plain NMS's IoU table computed at once
_NMS_ROWS = 1024


def ieee_div(x, d):
    """``x / d`` for a number ``d`` as an IEEE division on every device:
    PyTorch's CUDA kernel multiplies by the reciprocal of a host scalar,
    which can differ in the last bit and move a floor or a ceil."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _coord_dtype(data):
    """The type the bins' bounds are computed in: float64 for float64
    data, else float32 (half rois are widened)."""
    return torch.float64 if data.dtype == torch.float64 else torch.float32


def _bins(length, nbins, start, size):
    """(R, nbins, length) membership of each roi's bins: bin i covers
    [start + floor(i * size / n), start + ceil((i + 1) * size / n))
    clipped to [0, length)."""
    i = torch.arange(nbins, dtype=start.dtype, device=start.device)
    lo = start[:, None] + torch.floor(ieee_div(i[None, :] * size[:, None],
                                              nbins))
    hi = start[:, None] + torch.ceil(ieee_div((i[None, :] + 1)
                                              * size[:, None], nbins))
    lo, hi = lo.clamp(0, length), hi.clamp(0, length)
    pos = torch.arange(length, dtype=start.dtype, device=start.device)
    return (pos >= lo[..., None]) & (pos < hi[..., None])


def roi_pooling_plain(data, rois, pooled_size, spatial_scale):
    """The plain version (any device, differentiable by autograd): the
    JAX op's masked max, over W then over H (``amax`` splits a tie's
    cotangent evenly, as ``jnp.max`` does), in chunks of rois that keep
    the intermediate under _PLAIN_CHUNK_BYTES."""
    from .contrib import _round_half_away
    ph, pw = pooled_size
    n, c, h, w = data.shape
    r = rois.detach().to(_coord_dtype(data))
    bidx = r[:, 0].to(torch.int64).clamp(0, n - 1)
    x1 = _round_half_away(r[:, 1] * spatial_scale)
    y1 = _round_half_away(r[:, 2] * spatial_scale)
    x2 = _round_half_away(r[:, 3] * spatial_scale)
    y2 = _round_half_away(r[:, 4] * spatial_scale)
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)
    mh = _bins(h, ph, y1, rh)                       # (R, ph, H)
    mw = _bins(w, pw, x1, rw)                       # (R, pw, W)
    # -1e30 as the data's type (-inf in the half types, as the JAX op's
    # weakly typed constant becomes)
    neg = torch.full((), _NEG, device=data.device).to(data.dtype)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, c * pw * h * w
                                            * data.element_size()))
    outs = []
    for s in range(0, r.shape[0], step):
        img = data[bidx[s:s + step]]                # (r, C, H, W)
        t = torch.where(mw[s:s + step, None, :, None, :],
                        img[:, :, None, :, :], neg).amax(dim=4)
        o = torch.where(mh[s:s + step, None, :, None, :],
                        t[:, :, None, :, :], neg).amax(dim=4)
        outs.append(torch.where(o <= _NEG / 2, torch.zeros_like(o), o))
    if not outs:
        return data.new_zeros((0, c, ph, pw))
    return torch.cat(outs)


def _check_roi_args(data, rois):
    if data.dtype not in _CODES:
        raise MXNetError(f"ROIPooling: data of {data.dtype} (float32, "
                         "float64, float16 or bfloat16)")
    if data.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise MXNetError(f"ROIPooling: data (N, C, H, W) and rois (R, 5), "
                         f"got {tuple(data.shape)} and {tuple(rois.shape)}")
    if rois.device != data.device:
        raise MXNetError("ROIPooling: data and rois on different devices")


def _roi_launch(name, data, rois, scale, pooled, *bufs):
    n, c, h, w = data.shape
    if rois.shape[0] * c * pooled[0] * pooled[1] == 0:
        return                                      # nothing to launch
    fn = _build.bind("roi_pooling", name, *[ctypes.c_void_p] * len(bufs),
                     ctypes.c_int, ctypes.c_int, ctypes.c_double,
                     *[ctypes.c_int] * 7, ctypes.c_int, ctypes.c_void_p)
    err = fn(*[b.data_ptr() for b in bufs], _CODES[data.dtype],
             int(rois.dtype == torch.float64), float(scale), n, c, h, w,
             rois.shape[0], pooled[0], pooled[1], data.device.index or 0,
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "roi_pooling", "ROIPooling")
    roi_pooling.launches += 1


class _ROIPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, rois, pooled, scale):
        out = torch.empty((rois.shape[0], data.shape[1]) + tuple(pooled),
                          dtype=data.dtype, device=data.device)
        _roi_launch("mxt_roi_pool_fwd", data, rois, scale, pooled, data,
                    rois, out)
        ctx.save_for_backward(data, rois)
        ctx.pooled, ctx.scale = pooled, scale
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois = ctx.saved_tensors
        acc = torch.zeros(data.shape, device=data.device,
                          dtype=torch.float64 if data.dtype == torch.float64
                          else torch.float32)
        _roi_launch("mxt_roi_pool_bwd", data, rois, ctx.scale, ctx.pooled,
                    data, rois, g.contiguous(), acc)
        return acc.to(data.dtype), None, None, None


def roi_pooling(data, rois, pooled_size, spatial_scale):
    """ROIPooling of ``data`` (N, C, H, W) over ``rois`` (R, 5): (R, C,
    PH, PW). CUDA tensors launch the kernel (float32, float64, float16,
    bfloat16; the backward too); host tensors take the plain version."""
    _check_roi_args(data, rois)
    pooled = (int(pooled_size[0]), int(pooled_size[1]))
    if data.device.type == "cpu":
        return roi_pooling_plain(data, rois, pooled, spatial_scale)
    r = rois.detach().to(_coord_dtype(data)).contiguous()
    return _ROIPool.apply(data.contiguous(), r, pooled, float(spatial_scale))


roi_pooling.launches = 0


def proposal_nms_plain(boxes, thresh):
    """The plain version (any device): the JAX package's _nms_keep over
    every row of each image's score-sorted ``boxes`` (B, n, 4), all of
    them valid, IoU ``>= thresh`` suppressing: (B, n) bool. The IoUs of
    _NMS_ROWS reference rows at a time, then a row at a time in order."""
    from .contrib import _pair_iou
    nb, n = boxes.shape[0], boxes.shape[1]
    keep = torch.ones(nb, n, dtype=torch.bool, device=boxes.device)
    idx = torch.arange(n, device=boxes.device)
    for r0 in range(0, n - 1, _NMS_ROWS):
        r1 = min(n, r0 + _NMS_ROWS)
        over = (_pair_iou(boxes[:, r0:r1], boxes) >= thresh) \
            & (idx[None, None, :] > idx[r0:r1, None])
        for t in range(r1 - r0):
            keep &= ~(over[:, t] & keep[:, r0 + t:r0 + t + 1])
    return keep


def proposal_nms(boxes, thresh):
    """Greedy NMS keep mask (B, n) of score-sorted corner ``boxes`` (B,
    n, 4), float32 or float64: a box is kept unless an earlier kept box
    has IoU >= ``thresh`` with it. CUDA tensors launch the kernel (two
    launches, no host read); host tensors take the plain version."""
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise MXNetError(f"proposal_nms: boxes (B, n, 4), got "
                         f"{tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return proposal_nms_plain(boxes, thresh)
    if boxes.dtype not in (torch.float32, torch.float64):
        raise MXNetError(f"proposal_nms: boxes of {boxes.dtype} (float32 "
                         "or float64)")
    b = boxes.detach().contiguous()
    nb, n = b.shape[0], b.shape[1]
    words = (n + 63) // 64
    if words * 8 > 227 * 1024:
        raise MXNetError(f"proposal_nms: {n} boxes an image is past the "
                         "sweep's shared memory")
    keep = torch.empty((nb, n), dtype=torch.bool, device=b.device)
    if nb == 0 or n == 0:
        return keep                                 # nothing to launch
    mask = torch.empty((nb, n, words), dtype=torch.int64, device=b.device)
    fn = _build.bind("proposal_nms", "mxt_proposal_nms", ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p)
    err = fn(b.data_ptr(), int(b.dtype == torch.float64), nb, n,
             float(thresh), mask.data_ptr(), keep.data_ptr(),
             b.device.index or 0,
             torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "proposal_nms", "proposal NMS")
    proposal_nms.launches += 1
    return keep


proposal_nms.launches = 0
