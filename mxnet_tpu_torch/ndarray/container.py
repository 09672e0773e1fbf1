"""Read side of the reference NDArray ``.params`` container.

A copy of the JAX package's dense reader (mxnet_tpu/predictor.py
``_read_container_dense``), kept here so the port reads the JAX package's
``.mxa`` params without importing it. Returns numpy arrays.
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["_read_container_dense"]

# reference NDArray container constants (src/ndarray/ndarray.cc:1582-1808)
_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}


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
    return dict(zip(names, arrays))
