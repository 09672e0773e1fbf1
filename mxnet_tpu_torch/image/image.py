"""The image helpers that the vision transforms call (counterpart of
mxnet_tpu/image/image.py:53-110): ``imresize``, ``resize_short``,
``fixed_crop`` and ``center_crop``, on HWC images in numpy. The rest of
``image`` (decoders, augmenters, ``ImageIter``) is ROADMAP queue 1 item
17.

The JAX package resizes with OpenCV where it is installed; the port
needs no OpenCV and computes OpenCV's resampling in float64: the same
pixel-centre mapping (``(d + 0.5) * scale - 0.5``), replicated borders,
and the same kernels for the ``interp`` codes 0 nearest, 1 bilinear, 2
bicubic (A = -0.75), 3 area, 4 Lanczos-4. An 8-bit image is rounded to
the nearest integer at the end, where OpenCV sums in fixed point: the
two can differ by one unit. Images come back as host NDArrays.
"""
from __future__ import annotations

import math

import numpy as np

from ..context import cpu
from ..ndarray.ndarray import NDArray, array

__all__ = ["imresize", "resize_short", "fixed_crop", "center_crop"]


def _numpy(src):
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _cubic(x, a=-0.75):
    return np.stack([((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1)
                     - 4 * a,
                     ((a + 2) * x - (a + 3)) * x * x + 1,
                     ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1],
                    -1)


def _lanczos4(x):
    t = x[:, None] + 3 - np.arange(8)
    w = np.sinc(t) * np.sinc(t / 4)
    return w / w.sum(1, keepdims=True)


def _area_weights(n_src, n_dst, shrink):
    """OpenCV's INTER_AREA as a (n_dst, n_src) matrix: each output cell
    averages the source cells it covers, in fractions, when both axes
    shrink; else bilinear with OpenCV's area mapping."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src))
    if not shrink:
        for d in range(n_dst):
            s = math.floor(d * scale)
            f = (d + 1) - (s + 1) / scale
            f = 0.0 if f <= 0 else f - math.floor(f)
            w[d, min(s, n_src - 1)] += 1 - f
            w[d, min(s + 1, n_src - 1)] += f
        return w
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), min(math.floor(f2), n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return w


def _weights(n_src, n_dst, interp, shrink):
    """The (n_dst, n_src) resampling matrix of one axis (``shrink``: both
    axes shrink, which decides INTER_AREA's method)."""
    if interp == 3:
        return _area_weights(n_src, n_dst, shrink)
    scale = n_src / n_dst
    dst = np.arange(n_dst)
    w = np.zeros((n_dst, n_src))
    if interp == 0:
        w[dst, np.minimum(np.floor(dst * scale).astype(np.int64),
                          n_src - 1)] = 1.0
        return w
    f = (dst + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    if interp == 2:
        taps, k = _cubic(f), 4
        taps = np.concatenate([taps, 1 - taps.sum(1, keepdims=True)], 1)
    elif interp == 4:
        taps, k = _lanczos4(f), 8
    else:
        # bilinear (any other code, as OpenCV's table lookup falls back)
        low, high = s < 0, s >= n_src - 1
        f = np.where(low | high, 0.0, f)
        s = np.where(low, 0, np.where(high, n_src - 1, s))
        taps, k = np.stack([1 - f, f], 1), 2
    idx = np.clip(s[:, None] + np.arange(k) - (k // 2 - 1), 0, n_src - 1)
    np.add.at(w, (np.repeat(dst, k), idx.reshape(-1)), taps.reshape(-1))
    return w


def imresize(src, w, h, interp=1):
    """``src`` (H, W[, C]) resampled to (h, w[, C]) with OpenCV's
    ``interp`` code; an 8-bit image stays 8-bit."""
    data = _numpy(src)
    img = data[:, :, None] if data.ndim == 2 else data
    shrink = h <= img.shape[0] and w <= img.shape[1]
    wy = _weights(img.shape[0], h, interp, shrink)
    wx = _weights(img.shape[1], w, interp, shrink)
    out = np.einsum("yh,hwc,xw->yxc", wy, img.astype(np.float64), wx)
    if np.issubdtype(data.dtype, np.integer):
        info = np.iinfo(data.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    out = out.astype(data.dtype)
    return array(out, ctx=cpu(), dtype=out.dtype)


def resize_short(src, size, interp=2):
    """Resize so that the shorter side is ``size``, keeping the aspect
    ratio."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (w, h) window at (x0, y0), resized to ``size`` when given."""
    data = _numpy(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(data, size[0], size[1], interp=interp)
    return array(data, ctx=cpu(), dtype=data.dtype)


def center_crop(src, size, interp=2):
    """The centred ``size`` window (resized when the image is smaller),
    and its (x0, y0, w, h)."""
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)
