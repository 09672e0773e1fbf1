"""Batch assembly of ``ImageRecordIter``'s card route: what the JAX
package's native pipeline does to a record after the JPEG decode
(``ProcessRecord``, src/runtime_native.cc:357-430), for a whole batch.

- :func:`plan_record` is the host's part: the label from the record
  header, the size after the resize of the short side, and the crop and
  mirror drawn by the pipeline's xorshift64* from the record's seed
  (:func:`record_seed`, l.515 and l.291-299);
- :func:`assemble` builds the (B, 3, H, W) batch from the decoded images
  (interleaved RGB uint8, packed in one buffer) and the plans: on the card
  the hand-written kernel of ``csrc/image_assemble.cu`` (one launch a
  batch; ``assemble.launches`` counts them), for host tensors
  :func:`assemble_plain`, the same arithmetic in PyTorch (float32 ops,
  each rounded as the C++ rounds it, so the two agree bit for bit).
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from .. import _build
from ..base import MXNetError

__all__ = ["record_seed", "plan_record", "RecordPlan", "assemble",
           "assemble_plain", "descriptors", "resized_size"]

_M64 = (1 << 64) - 1
_IR = struct.Struct("IfQQ")


def _next(state):
    """xorshift64*: (new state, output), as ``NextRand``."""
    x = state
    x ^= x >> 12
    x ^= (x << 25) & _M64
    x ^= x >> 27
    return x, (x * 0x2545F4914F6CDD1D) & _M64


def record_seed(seed, epoch, idx):
    """The generator state a record starts from: the pipeline's per
    (seed, epoch, record) seed, advanced once (``WorkerLoop``)."""
    s = ((seed * 1000003 + epoch) * 0x9E3779B97F4A7C15 + idx + 1) & _M64
    return _next(s)[0]


def resized_size(h, w, resize):
    """(h, w) after the resize of the short side to ``resize`` (0: none,
    or already that size), with the pipeline's double arithmetic."""
    short = min(h, w)
    if resize <= 0 or short == resize:
        return h, w
    scale = resize / short
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    if h < w:
        nh = resize
    else:
        nw = resize
    return nh, nw


class RecordPlan:
    """One record's place in a batch: its JPEG payload, label, decoded
    size, size after the resize, crop origin and mirror."""
    __slots__ = ("payload", "label", "sh", "sw", "rh", "rw", "y0", "x0",
                 "mirror")

    def __init__(self, payload, label, sh, sw, rh, rw, y0, x0, mirror):
        self.payload, self.label = payload, label
        self.sh, self.sw, self.rh, self.rw = sh, sw, rh, rw
        self.y0, self.x0, self.mirror = y0, x0, mirror

    def draws(self):
        return (self.rh, self.rw, self.y0, self.x0, self.mirror)


def split_record(rec, label_width):
    """(label float32[label_width], image payload) of a record, as the
    pipeline reads its header (a multi-label record's floats first)."""
    if len(rec) < _IR.size:
        raise MXNetError("ImageRecordIter: record shorter than its header")
    flag, flabel, _, _ = _IR.unpack_from(rec)
    body = memoryview(rec)[_IR.size:]
    label = np.zeros(label_width, np.float32)
    if flag > 0:
        if len(body) < flag * 4:
            raise MXNetError("ImageRecordIter: label longer than its record")
        k = min(flag, label_width)
        label[:k] = np.frombuffer(body[:k * 4], np.float32)
        body = body[flag * 4:]
    else:
        label[0] = flabel
    return label, bytes(body)


def plan_record(rec, size_of, seed, epoch, idx, data_shape, resize,
                rand_crop, rand_mirror, label_width):
    """The host's part of one record. ``size_of(payload)`` gives the
    decoded (h, w) (read from the JPEG header)."""
    label, payload = split_record(rec, label_width)
    if len(payload) < 2 or payload[0] != 0xFF or payload[1] != 0xD8:
        raise MXNetError("ImageRecordIter: record %d is not a JPEG" % idx)
    _, out_h, out_w = data_shape
    sh, sw = size_of(payload)
    rh, rw = resized_size(sh, sw, resize)
    if rh < out_h or rw < out_w:
        raise MXNetError(
            "ImageRecordIter: record %d is %dx%d, smaller than the crop "
            "%dx%d (set resize=)" % (idx, rh, rw, out_h, out_w))
    rs = record_seed(seed, epoch, idx)
    y0, x0 = (rh - out_h) // 2, (rw - out_w) // 2
    if rand_crop:
        if rh == out_h:
            y0 = 0
        else:
            rs, r = _next(rs)
            y0 = r % (rh - out_h + 1)
        if rw == out_w:
            x0 = 0
        else:
            rs, r = _next(rs)
            x0 = r % (rw - out_w + 1)
    mirror = 0
    if rand_mirror:
        rs, r = _next(rs)
        mirror = int(r & 1)
    return RecordPlan(payload, label, sh, sw, rh, rw, int(y0), int(x0),
                      mirror)


def _stats(mean, std):
    """Per-channel mean and 1/std as float32 triples (None: 0 and 1), the
    pipeline's: 1/std is taken in float32."""
    m = np.zeros(3, np.float32) if mean is None else \
        np.broadcast_to(np.asarray(mean, np.float32).ravel(), (3,))
    s = np.ones(3, np.float32) if std is None else \
        (np.float32(1.0) / np.broadcast_to(
            np.asarray(std, np.float32).ravel(), (3,))).astype(np.float32)
    return m.astype(np.float32), s


def descriptors(plans, offsets, device):
    """The kernel's per-image descriptors (``MxtImgDesc``: the image's
    byte offset, decoded and resized sizes, crop origin, mirror) as an
    int32 tensor on ``device``."""
    d = np.zeros((len(plans), 10), np.int32)
    off = np.asarray(offsets, np.int64)
    d[:, 0] = (off & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    d[:, 1] = (off >> 32).astype(np.int32)
    for i, p in enumerate(plans):
        d[i, 2:9] = (p.sh, p.sw, p.rh, p.rw, p.y0, p.x0, p.mirror)
    return torch.from_numpy(d).to(device)


def _resize_plain(img, sh, sw, rh, rw):
    """ResizeBilinearRGB on a (sh, sw, 3) uint8 tensor, in float32 ops
    rounded as the C++ rounds them."""
    f32 = torch.float32
    dev = img.device

    def axis(n_dst, n_src):
        s = torch.tensor(n_src, dtype=f32) / torch.tensor(n_dst, dtype=f32)
        f = (torch.arange(n_dst, device=dev, dtype=f32) + 0.5) * s.to(dev) \
            - 0.5
        f = torch.clamp(f, min=0.0)
        i0 = torch.clamp(f.to(torch.int64), max=n_src - 1)
        i1 = torch.clamp(i0 + 1, max=n_src - 1)
        return i0, i1, f - i0.to(f32)
    y0, y1, wy = axis(rh, sh)
    x0, x1, wx = axis(rw, sw)
    src = img.to(f32)
    wy, wx = wy[:, None, None], wx[None, :, None]
    owy, owx = 1.0 - wy, 1.0 - wx
    v = src[y0][:, x0] * owy * owx
    v = v + src[y0][:, x1] * owy * wx
    v = v + src[y1][:, x0] * wy * owx
    v = v + src[y1][:, x1] * wy * wx
    return (v + 0.5).to(torch.uint8)


def assemble_plain(raw, plans, offsets, out_hw, out_dtype="uint8",
                   mean=None, std=None):
    """The plain PyTorch version of :func:`assemble` (any device)."""
    out_h, out_w = out_hw
    f32 = out_dtype == "float32"
    m, s = _stats(mean, std)
    out = torch.empty((len(plans), 3, out_h, out_w), device=raw.device,
                      dtype=torch.float32 if f32 else torch.uint8)
    for b, (p, off) in enumerate(zip(plans, offsets)):
        img = raw[off:off + p.sh * p.sw * 3].view(p.sh, p.sw, 3)
        if (p.rh, p.rw) != (p.sh, p.sw):
            img = _resize_plain(img, p.sh, p.sw, p.rh, p.rw)
        crop = img[p.y0:p.y0 + out_h, p.x0:p.x0 + out_w]
        if p.mirror:
            crop = crop.flip(1)
        chw = crop.permute(2, 0, 1)
        if f32:
            chw = (chw.to(torch.float32)
                   - torch.from_numpy(m).to(raw.device)[:, None, None]) \
                * torch.from_numpy(s).to(raw.device)[:, None, None]
        out[b] = chw
    return out


def assemble(raw, plans, offsets, out_hw, out_dtype="uint8", mean=None,
             std=None, desc=None):
    """The (B, 3, H, W) batch of ``plans`` from ``raw`` (a uint8 tensor:
    the decoded images, interleaved RGB, image b at ``offsets[b]``), as
    uint8 or float32 ``(x - mean) / std``. A CUDA ``raw`` launches the
    kernel on the current stream (or raises); a host one takes
    :func:`assemble_plain`. ``desc``: :func:`descriptors` of the plans,
    made already (else made here)."""
    if out_dtype not in ("uint8", "float32"):
        raise MXNetError("assemble: out_dtype is uint8 or float32")
    if raw.dtype != torch.uint8 or raw.dim() != 1:
        raise MXNetError("assemble: raw must be a flat uint8 tensor")
    if raw.device.type == "cpu":
        return assemble_plain(raw, plans, offsets, out_hw, out_dtype, mean,
                              std)
    if not raw.is_contiguous():
        raise MXNetError("assemble: raw must be contiguous")
    for p, off in zip(plans, offsets):
        if off < 0 or off + p.sh * p.sw * 3 > raw.numel():
            raise MXNetError("assemble: an image lies outside raw")
    out_h, out_w = out_hw
    f32 = out_dtype == "float32"
    m, s = _stats(mean, std)
    if desc is None:
        desc = descriptors(plans, offsets, raw.device)
    out = torch.empty((len(plans), 3, out_h, out_w), device=raw.device,
                      dtype=torch.float32 if f32 else torch.uint8)
    fn = _build.bind("image_assemble", "mxt_image_assemble",
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     *[ctypes.c_float] * 6, ctypes.c_int, ctypes.c_void_p)
    err = fn(raw.data_ptr(), desc.data_ptr(), out.data_ptr(), len(plans),
             out_h, out_w, int(f32), *[float(v) for v in m],
             *[float(v) for v in s], raw.device.index or 0,
             torch.cuda.current_stream(raw.device).cuda_stream)
    _build.check(err, "image_assemble", "image assembly")
    assemble.launches += 1
    return out


assemble.launches = 0
