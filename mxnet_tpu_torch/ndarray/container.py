"""The reference NDArray ``.params`` container.

The reader is a copy of the JAX package's dense reader
(mxnet_tpu/predictor.py ``_read_container_dense``), kept here so the port
reads the JAX package's ``.params`` files and ``.mxa`` params without
importing it; the writer emits the same V2 list form as
mxnet_tpu/ndarray/container.py ``container_bytes``, so the JAX package
reads what the port saves, byte for byte. Arrays are numpy on both
sides; a file without names (``nd.save`` of a list) reads as a list.

Sparse arrays take the reference's aux layout (storage types 1
row_sparse, 2 csr; src/ndarray/ndarray.cc:1597-1650): a row_sparse blob
holds its values (storage shape (stored rows, ...)) and one int64 row-id
aux; a csr blob its values ((nnz,)) and int64 indptr and column auxes.
They are :class:`SparseBlob` records on both sides of the file; only
``nd.save`` / ``nd.load`` (``sparse=True``) take them, every other reader
refuses a sparse blob.
"""
from __future__ import annotations

import collections
import os
import struct
import tempfile

import numpy as np

__all__ = ["_read_container_dense", "container_bytes", "save_container",
           "load_container", "SparseBlob", "blob_of"]

# reference NDArray container constants (src/ndarray/ndarray.cc:1582-1808)
_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_TO_FLAG = {np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}


# stype "row_sparse": parts (values, row ids); "csr": (values, column
# indices, indptr), the csr_matrix triplet; shape the dense shape
SparseBlob = collections.namedtuple("SparseBlob", "stype parts shape")


def blob_of(nd):
    """What the writer takes for an NDArray: numpy, or a SparseBlob of
    a row_sparse / csr array's parts."""
    stype = getattr(nd, "stype", "default")
    if stype == "row_sparse":
        return SparseBlob(stype, (nd.data.asnumpy(), nd.indices.asnumpy()),
                          nd.shape)
    if stype == "csr":
        return SparseBlob(stype, (nd.data.asnumpy(), nd.indices.asnumpy(),
                                  nd.indptr.asnumpy()), nd.shape)
    return nd.asnumpy()


def _read_container_dense(buf, sparse=False):
    """Minimal reader of the reference .params container: dense blobs,
    and with ``sparse`` row_sparse / csr blobs as SparseBlobs."""
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

    def values(dt, s):
        dt = np.dtype(dt)
        n = int(np.prod(s, dtype=np.int64))
        return np.frombuffer(take(n * dt.itemsize),
                             dt.newbyteorder("<")).reshape(s)

    if u64() != _LIST_MAGIC:
        raise ValueError("not an NDArray container")
    u64()
    arrays = []
    for _ in range(u64()):
        if u32() != _V2_MAGIC:
            raise ValueError("container: only V2 blobs supported")
        stype = i32()
        if stype not in (0, 1, 2):
            raise ValueError(f"container: unknown storage type {stype}")
        if stype and not sparse:
            raise ValueError("container: sparse params unsupported here "
                             "(nd.load reads them)")
        sshape = shape() if stype else None
        s = shape()
        i32(), i32()
        dt = _FLAG_TO_DTYPE[i32()]
        aux = [(_FLAG_TO_DTYPE[i32()], shape()) for _ in range(stype)]
        if not stype:
            arrays.append(values(dt, s))
            continue
        vals = values(dt, sshape)
        auxes = [values(d, a) for d, a in aux]
        if stype == 1:
            arrays.append(SparseBlob("row_sparse", (vals, auxes[0]), s))
        else:       # aux 0 indptr, aux 1 column indices
            arrays.append(SparseBlob("csr", (vals, auxes[1], auxes[0]), s))
    names = [take(u64()).decode("utf-8") for _ in range(u64())]
    if not names:
        return arrays                   # the list form: no names
    if len(names) != len(arrays):
        raise ValueError(f"container: {len(arrays)} arrays but "
                         f"{len(names)} names")
    return dict(zip(names, arrays))


def _flag(a, n):
    flag = _DTYPE_TO_FLAG.get(a.dtype)
    if flag is None:
        raise ValueError(f"container: dtype {a.dtype} of {n!r} has no "
                         "reference type flag")
    return flag


def _shape_bytes(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(np.asarray(shape, dtype="<i8").tobytes())


def _sparse_bytes(out, blob, n):
    """One row_sparse / csr blob: stype, storage shape, shape, context,
    value type, each aux's type and shape, values, auxes."""
    vals = np.ascontiguousarray(blob.parts[0])
    if blob.stype == "row_sparse":
        stype, auxes = 1, [blob.parts[1]]
    else:
        stype, auxes = 2, [blob.parts[2], blob.parts[1]]   # indptr, idx
    auxes = [np.ascontiguousarray(x, dtype="<i8").reshape(-1)
             for x in auxes]
    out.append(struct.pack("<Ii", _V2_MAGIC, stype))
    _shape_bytes(out, vals.shape)
    _shape_bytes(out, tuple(blob.shape))
    out.append(struct.pack("<iii", 1, 0, _flag(vals, n)))
    for x in auxes:
        out.append(struct.pack("<i", 6))                   # int64
        _shape_bytes(out, x.shape)
    out.append(vals.astype(vals.dtype.newbyteorder("<")).tobytes())
    for x in auxes:
        out.append(x.tobytes())


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
        n = names[i] if names else f"array {i}"
        if isinstance(a, SparseBlob):
            _sparse_bytes(out, a, n)
            continue
        a = np.ascontiguousarray(a)
        out.append(struct.pack("<Ii", _V2_MAGIC, 0))
        _shape_bytes(out, a.shape)
        out.append(struct.pack("<iii", 1, 0, _flag(a, n)))
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


def load_container(fname, sparse=False):
    """{name: numpy array} of a container file ([numpy array] for the
    list form); with ``sparse``, SparseBlobs for sparse arrays."""
    with open(fname, "rb") as f:
        return _read_container_dense(f.read(), sparse=sparse)
