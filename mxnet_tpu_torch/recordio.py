"""RecordIO: binary record files (counterpart of mxnet_tpu/recordio.py).

dmlc-core's recordio framing in pure Python: the magic 0xced7230a, a
uint32 length word whose top 3 bits are the continuation flag, payloads
padded to 4 bytes. ``MXIndexedRecordIO`` adds the text ``.idx`` seek
table; ``pack`` / ``unpack`` carry the ``IRHeader`` (flag, label, id,
id2) of im2rec's datasets. Files are byte for byte the JAX package's in
both directions.

``pack_img`` / ``unpack_img`` take a ``ctx``: the card by default, which
encodes and decodes JPEG with nvJPEG (``image.codec``; BGR, as OpenCV's
``imencode`` / ``imdecode`` take and give it, and the decoded image stays
on the card as an NDArray); ``ctx=cpu()`` uses OpenCV, and PIL where
OpenCV is missing, as the JAX package does, and gives numpy.

``scan_record_positions`` is the pure-Python walk over the framing: the
port has no native fast path for it yet (the JAX package's is C++).
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .context import Context, current_context

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "scan_record_positions"]

_kMagic = 0xced7230a


try:
    import cv2 as _cv2
except ImportError:
    _cv2 = None
# the host codec's backend (cv2 = BGR), as the JAX package exports it
USES_CV2 = _cv2 is not None


class MXRecordIO:
    """Sequential record reader/writer (recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fp = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("fp", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d["is_open"]
        self.is_open = False
        self.fp = None
        if is_open:
            self.open()

    def close(self):
        if self.is_open and self.fp is not None:
            self.fp.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        if len(buf) >= (1 << 29):
            raise ValueError(
                f"record too large ({len(buf)} bytes): the dmlc recordio "
                "length word holds 29 bits (max 512MB per record)")
        self.fp.write(struct.pack("<I", _kMagic))
        self.fp.write(struct.pack("<I", len(buf)))
        self.fp.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        hdr = self.fp.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _kMagic:
            raise IOError("Invalid RecordIO magic number")
        length = lrec & ((1 << 29) - 1)
        buf = self.fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fp.read(pad)
        return buf

    def tell(self):
        return self.fp.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a text .idx seek table
    (recordio.py MXIndexedRecordIO); without one, the table is built by
    walking the framing."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            return
        if self.idx_path and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        else:
            offsets, _ = scan_record_positions(self.uri)
            for i, off in enumerate(offsets):
                key = self.key_type(i)
                # stored offsets point at the record START (magic word)
                self.idx[key] = int(off) - 8
                self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload into a record string. Multi-label uses
    flag = label count and prepends float32 labels."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Unpack a record into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s[:header.flag * 4], dtype=np.float32))
        s = s[header.flag * 4:]
    return header, s


def _on_host(ctx):
    ctx = Context(ctx) if ctx is not None else current_context()
    return ctx.device_type == "cpu", ctx


def pack_img(header, img, quality=95, img_fmt=".jpg", ctx=None):
    """Pack an image (BGR, as OpenCV takes it; numpy, tensor or NDArray) into a
    record, encoded on ``ctx``: nvJPEG on the card (JPEG only), OpenCV
    or PIL with ``ctx=cpu()``."""
    from .image import codec
    host, ctx = _on_host(ctx)
    if host:
        data = img.asnumpy() if hasattr(img, "asnumpy") else img
        return pack(header, codec.host_encode(data, quality, img_fmt))
    if img_fmt.lower() not in (".jpg", ".jpeg"):
        raise ValueError("nvJPEG encodes JPEG only: pack %s images with "
                         "ctx=cpu()" % img_fmt)
    import torch
    from .ndarray.ndarray import NDArray
    t = img._data if isinstance(img, NDArray) else img
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.to(ctx.torch_device(), torch.uint8)
    return pack(header, codec.encode(t, quality, bgr=True))


def unpack_img(s, iscolor=-1, ctx=None):
    """Unpack a record into (IRHeader, image). ``ctx=cpu()``: OpenCV's
    ``imdecode(s, iscolor)`` (BGR numpy), or PIL's image. The card:
    nvJPEG, an NDArray there, BGR (H, W, 3), or (H, W) for ``iscolor``
    0 or a one-component JPEG with ``iscolor`` -1."""
    from .image import codec
    header, s = unpack(s)
    host, ctx = _on_host(ctx)
    if host:
        return header, codec.host_decode(s, iscolor)
    from .ndarray.ndarray import NDArray
    comps = codec.jpeg_size(s)[2] if codec.is_jpeg(s) else 3
    gray = iscolor == 0 or (iscolor < 0 and comps == 1)
    img = codec.decode(s, ctx.torch_device(), 1 if gray else 3,
                       to_rgb=False)
    return header, NDArray(img[:, :, 0] if gray else img)


def scan_record_positions(uri):
    """(payload_offsets, lengths) arrays for every record in a .rec file,
    by walking its framing."""
    offsets, lengths = [], []
    with open(uri, "rb") as fp:
        while True:
            pos = fp.tell()
            hdr = fp.read(8)
            if len(hdr) < 8:
                break
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _kMagic:
                raise IOError(f"corrupt recordio file: {uri}")
            length = lrec & ((1 << 29) - 1)
            offsets.append(pos + 8)
            lengths.append(length)
            fp.seek((length + 3) & ~3, 1)
    return (np.asarray(offsets, np.int64), np.asarray(lengths, np.int64))
