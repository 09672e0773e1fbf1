"""The reference NDArray ``.params`` container, dense arrays only.

The reader is a copy of the JAX package's dense reader
(mxnet_tpu/predictor.py ``_read_container_dense``), kept here so the port
reads the JAX package's ``.params`` files and ``.mxa`` params without
importing it; the writer emits the same V2 list form as
mxnet_tpu/ndarray/container.py ``container_bytes``, so the JAX package
reads what the port saves, byte for byte. Arrays are numpy on both
sides; a file without names (``nd.save`` of a list) reads as a list.
"""
from __future__ import annotations

import os
import struct
import tempfile

import numpy as np

__all__ = ["_read_container_dense", "container_bytes", "save_container",
           "load_container"]

# reference NDArray container constants (src/ndarray/ndarray.cc:1582-1808)
_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_TO_FLAG = {np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}


def _read_container_dense(buf):
    """Minimal dense-only reader of the reference .params container."""
    pos = 0

    def take(n):
        nonlocal pos
        b = buf[pos:pos + n]
        if len(b) != n:
            raise ValueError("truncated container")
        pos += n
        return b

    def u32():
        return struct.unpack("<I", take(4))[0]

    def i32():
        return struct.unpack("<i", take(4))[0]

    def u64():
        return struct.unpack("<Q", take(8))[0]

    def shape():
        return tuple(np.frombuffer(take(8 * u32()), "<i8").tolist())

    if u64() != _LIST_MAGIC:
        raise ValueError("not an NDArray container")
    u64()
    arrays = []
    for _ in range(u64()):
        if u32() != _V2_MAGIC:
            raise ValueError("container: only V2 dense blobs supported")
        if i32() != 0:
            raise ValueError("container: sparse params unsupported")
        s = shape()
        i32(), i32()
        dt = np.dtype(_FLAG_TO_DTYPE[i32()])
        n = int(np.prod(s, dtype=np.int64))
        arrays.append(np.frombuffer(take(n * dt.itemsize),
                                    dt.newbyteorder("<")).reshape(s))
    names = [take(u64()).decode("utf-8") for _ in range(u64())]
    if not names:
        return arrays                   # the list form: no names
    if len(names) != len(arrays):
        raise ValueError(f"container: {len(arrays)} arrays but "
                         f"{len(names)} names")
    return dict(zip(names, arrays))


def container_bytes(arrays):
    """{name: array} or [array] -> container bytes (NDArray::Save list
    form: V2 dense blobs with a cpu(0) context, then the names; a list
    has none)."""
    if isinstance(arrays, dict):
        names, values = list(arrays), list(arrays.values())
    else:
        names, values = [], list(arrays)
    out = [struct.pack("<QQ", _LIST_MAGIC, 0),
           struct.pack("<Q", len(values))]
    for i, a in enumerate(values):
        a = np.ascontiguousarray(a)
        n = names[i] if names else f"array {i}"
        flag = _DTYPE_TO_FLAG.get(a.dtype)
        if flag is None:
            raise ValueError(f"container: dtype {a.dtype} of {n!r} has no "
                             "reference type flag")
        out.append(struct.pack("<Ii", _V2_MAGIC, 0))
        out.append(struct.pack("<I", a.ndim))
        out.append(np.asarray(a.shape, dtype="<i8").tobytes())
        out.append(struct.pack("<iii", 1, 0, flag))
        out.append(a.astype(a.dtype.newbyteorder("<")).tobytes())
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)


def save_container(fname, arrays):
    """Write {name: array} or [array] atomically (temp file + rename)."""
    fname = os.fspath(fname)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fname) or ".",
                               prefix=os.path.basename(fname) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(container_bytes(arrays))
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_container(fname):
    """{name: numpy array} of a container file ([numpy array] for the
    list form)."""
    with open(fname, "rb") as f:
        return _read_container_dense(f.read())
