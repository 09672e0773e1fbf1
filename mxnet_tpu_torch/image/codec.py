"""Image encode and decode for the port: on the host with OpenCV (PIL
where OpenCV is missing), as the JAX package does
(mxnet_tpu/recordio.py:218-241, image/image.py:25-46), and on the card
with nvJPEG through ``csrc/nvjpeg_codec.cu``.

The card codec keeps one nvJPEG context (handle, decoder and encoder
state) a thread and card, on nvJPEG's default backend (Huffman on the
calling thread, the rest on the card). ``hardware_status()`` says whether
nvJPEG would give a handle on the card's hardware JPEG decoder; nothing
decodes through one. Images come out interleaved, RGB or BGR, in device
memory. ``decoded`` counts the images nvJPEG
decoded, ``encoded`` those it encoded. Nothing is built or loaded when
the module is imported.
"""
from __future__ import annotations

import ctypes
import io as _io
import struct
import threading

import numpy as np
import torch

from .. import _build
from ..base import MXNetError

try:
    import cv2 as _cv2
except ImportError:
    _cv2 = None
# the host codec's backend (cv2 reads and writes BGR), as the JAX package
# exports it
USES_CV2 = _cv2 is not None

__all__ = ["USES_CV2", "host_encode", "host_decode", "host_imdecode",
           "jpeg_size", "is_jpeg", "encode", "decode", "decode_batch",
           "hardware_status", "counts"]

# nvjpegOutputFormat_t / flags (nvjpeg.h)
FMT_Y, FMT_RGBI, FMT_BGRI = 2, 5, 6
# NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION: chroma is upsampled by
# interpolation, as libjpeg's default ("fancy" upsampling) does, not by
# replication (which puts the decode 2.3 units from the JAX package's on
# average over tests/data/jpeg_fixture.npz: tools/torch_nvjpeg_probe.py)
FLAGS = 1 << 5


# -- the host codec ----------------------------------------------------------

def host_encode(img, quality=95, img_fmt=".jpg"):
    """Encoded bytes of a numpy image (BGR under OpenCV)."""
    img = np.asarray(img)
    if USES_CV2:
        flag = (_cv2.IMWRITE_JPEG_QUALITY
                if img_fmt.lower() in (".jpg", ".jpeg")
                else _cv2.IMWRITE_PNG_COMPRESSION)
        ret, buf = _cv2.imencode(img_fmt, img, [flag, quality])
        if not ret:
            raise MXNetError("failed to encode image")
        return buf.tobytes()
    pil = _pil().fromarray(img.astype(np.uint8))
    bio = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(bio, format=fmt, quality=quality)
    return bio.getvalue()


def host_decode(buf, iscolor=-1):
    """The JAX package's ``_decode_img``: OpenCV's ``imdecode(buf,
    iscolor)`` (BGR), else PIL's image as it is."""
    if USES_CV2:
        return _cv2.imdecode(np.frombuffer(buf, dtype=np.uint8), iscolor)
    return np.asarray(_pil().open(_io.BytesIO(buf)))


def host_imdecode(buf, flag=1, to_rgb=True):
    """``image.imdecode`` on the host: (H, W, C) uint8, RGB unless not
    ``to_rgb``; C is 1 when ``flag`` is 0."""
    if USES_CV2:
        img = _cv2.imdecode(np.frombuffer(buf, dtype=np.uint8),
                            1 if flag else 0)
        if img is None:
            raise MXNetError("imdecode: failed to decode buffer")
        if to_rgb and flag:
            img = _cv2.cvtColor(img, _cv2.COLOR_BGR2RGB)
    else:
        pil = _pil().open(_io.BytesIO(buf))
        img = np.asarray(pil.convert("RGB" if flag else "L"))
        if not to_rgb and flag:
            img = img[:, :, ::-1]
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("the host image codec needs OpenCV (cv2) or "
                         "PIL; neither is installed") from e
    return Image


# -- JPEG headers ------------------------------------------------------------

_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def is_jpeg(buf):
    return len(buf) >= 2 and buf[0] == 0xFF and buf[1] == 0xD8


def jpeg_size(buf):
    """(height, width, components) from a JPEG's frame header, read on
    the host without decoding."""
    if not is_jpeg(buf):
        raise MXNetError("not a JPEG (no SOI marker)")
    i, n = 2, len(buf)
    while i + 4 <= n:
        if buf[i] != 0xFF:
            raise MXNetError("corrupt JPEG: no marker at byte %d" % i)
        marker = buf[i + 1]
        if marker == 0xFF:               # fill byte
            i += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg = struct.unpack_from(">H", buf, i + 2)[0]
        if marker in _SOF:
            if i + 10 > n:
                break
            h, w = struct.unpack_from(">HH", buf, i + 5)
            return h, w, buf[i + 9]
        if marker == 0xDA:               # start of scan before a frame
            break
        i += 2 + seg
    raise MXNetError("corrupt JPEG: no frame header")


# -- the card codec ----------------------------------------------------------

_LOCAL = threading.local()
counts = {"decoded": 0, "encoded": 0, "batched_calls": 0}


def _lib(name, *argtypes):
    return _build.bind("nvjpeg_codec", name, *argtypes)


def _check(err, what):
    if err:
        fn = _build.library("nvjpeg_codec").mxt_jpeg_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise MXNetError("%s: %s (%d)" % (what, fn(err).decode(), err))


class _Codec:
    def __init__(self, device):
        self.device = device
        h = ctypes.c_void_p()
        fn = _lib("mxt_jpeg_create", ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_void_p))
        _check(fn(device, FLAGS, ctypes.byref(h)), "nvJPEG context")
        self.handle = h.value

    def __del__(self):
        # a thread's context goes with the thread (its thread-local dict)
        try:
            fn = _build.library("nvjpeg_codec").mxt_jpeg_destroy
            fn.argtypes, fn.restype = [ctypes.c_void_p], None
            fn(self.handle)
        except Exception:       # interpreter shutdown: the process frees it
            pass


def _codec(device):
    if device.type != "cuda":
        raise MXNetError("the nvJPEG codec runs on a CUDA device, not %s"
                         % device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    per = _LOCAL.__dict__.setdefault("codecs", {})
    c = per.get(idx)
    if c is None:
        c = per[idx] = _Codec(idx)
    return c


def hardware_status(device=None):
    """The nvjpegStatus_t with which nvJPEG answers a request for a handle
    on the hardware JPEG decoder of ``device`` (0: it would make one; 7,
    ARCH_MISMATCH: the card or the library has none). Asks only: the
    codec decodes on the default backend either way."""
    device = torch.device(device or "cuda")
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = _lib("mxt_jpeg_hardware_status", ctypes.c_int, ctypes.c_int)(
        idx, FLAGS)
    if 0 < err < 1000:
        _check(err, "nvJPEG hardware probe")
    return err - 1000 if err else 0


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _fmt(channels, to_rgb):
    return FMT_Y if channels == 1 else (FMT_RGBI if to_rgb else FMT_BGRI)


def decode(buf, device, channels=3, to_rgb=True):
    """One JPEG (bytes on the host) decoded by nvJPEG into a new (H, W,
    channels) uint8 tensor on ``device`` (channels 3: RGB, or BGR unless
    ``to_rgb``; 1: the luma plane). Waits for the card before it returns,
    so ``buf`` may go."""
    device = torch.device(device)
    if not is_jpeg(buf):
        raise MXNetError("nvJPEG decodes JPEG only: this buffer is not one "
                         "(decode it on the host with ctx=cpu())")
    c = _codec(device)
    h, w, _ = jpeg_size(buf)
    out = torch.empty((h, w, channels), dtype=torch.uint8, device=device)
    fn = _lib("mxt_jpeg_decode", ctypes.c_void_p, ctypes.c_char_p,
              ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_size_t, ctypes.c_void_p)
    _check(fn(c.handle, bytes(buf), len(buf),
              _fmt(channels, to_rgb), out.data_ptr(), w * channels,
              _stream(device)), "nvJPEG decode")
    torch.cuda.current_stream(device).synchronize()
    counts["decoded"] += 1
    return out


def decode_batch(bufs, raw, offsets, sizes, to_rgb=True):
    """Decode the JPEGs ``bufs`` (bytes) in one batched nvJPEG call into
    the flat uint8 tensor ``raw`` on a card, image i at ``offsets[i]``
    with (h, w) ``sizes[i]``, interleaved 3 channels, on the current
    stream; waits for it."""
    c = _codec(raw.device)
    n = len(bufs)
    if n == 0:
        return
    fn = _lib("mxt_jpeg_decode_batch", ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    keep = [bytes(b) for b in bufs]
    data = (ctypes.c_char_p * n)(*keep)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in keep])
    base = raw.data_ptr()
    outs = (ctypes.c_void_p * n)(*[base + int(o) for o in offsets])
    pitches = (ctypes.c_size_t * n)(*[int(w) * 3 for _, w in sizes])
    fmt = FMT_RGBI if to_rgb else FMT_BGRI
    st = _stream(raw.device)
    _check(fn(c.handle, n, data, lens, outs, pitches, fmt, st),
           "nvJPEG batched decode")
    torch.cuda.current_stream(raw.device).synchronize()
    counts["decoded"] += n
    counts["batched_calls"] += 1


def encode(img, quality=95, bgr=True):
    """JPEG bytes of an (H, W, 3) or (H, W[, 1]) uint8 tensor on a card,
    encoded by nvJPEG at ``quality`` (4:2:0 chroma, as OpenCV's
    default). ``bgr``: the channels are BGR (OpenCV's order, the JAX
    package's ``pack_img`` convention)."""
    if img.dim() == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    if ch not in (1, 3) or img.dtype != torch.uint8:
        raise MXNetError("nvJPEG encodes (H, W, 3) or (H, W, 1) uint8 "
                         "images, not %s %s" % (tuple(img.shape), img.dtype))
    img = img.contiguous()
    c = _codec(img.device)
    enc = _lib("mxt_jpeg_encode", ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.POINTER(ctypes.c_size_t))
    fetch = _lib("mxt_jpeg_encode_fetch", ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p)
    n = ctypes.c_size_t()
    st = _stream(img.device)
    _check(enc(c.handle, img.data_ptr(), w, h, ch, w * ch, int(quality),
               int(bool(bgr)), st, ctypes.byref(n)), "nvJPEG encode")
    out = ctypes.create_string_buffer(n.value)
    _check(fetch(c.handle, out, ctypes.byref(n), st), "nvJPEG encode")
    counts["encoded"] += 1
    return out.raw[:n.value]
