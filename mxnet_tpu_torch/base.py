"""Errors, naming, attribute scopes, dtypes and attr parsing shared by the
PyTorch port (counterpart of mxnet_tpu/base.py).

Dtypes are named as the JAX package names them; each name maps to a
``torch.dtype`` (``DTYPES``). numpy has no bfloat16 without
``ml_dtypes``, which the port does not use: ``to_numpy`` hands a
bfloat16 array to the host as float32.
"""
from __future__ import annotations

import ast
import os
import tempfile
import threading

import numpy as _np
import torch

__all__ = ["MXNetError", "NameManager", "AttrScope", "atomic_write",
           "to_numpy", "DTYPES", "torch_dtype", "dtype_name"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


def atomic_write(fname, payload, fsync=False):
    """Write ``payload`` (bytes or str) to ``fname`` atomically: a temp
    file in the destination directory, then ``os.replace`` into place,
    so a crash leaves the old file or the new one, never a torn mix."""
    fname = os.fspath(fname)
    d = os.path.dirname(fname) or "."
    mode = "wb" if isinstance(payload, (bytes, bytearray, memoryview)) \
        else "w"
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(fname) + ".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            f.write(payload)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# canonical name -> torch dtype
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in DTYPES.items()}


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype, numpy dtype, type or name."""
    if isinstance(dtype, torch.dtype):
        return _NAME_OF[dtype]
    if isinstance(dtype, str) and dtype in DTYPES:
        return dtype
    return _np.dtype(dtype).name


def torch_dtype(dtype) -> torch.dtype:
    """A user dtype (name, numpy dtype, type, torch dtype; None means
    float32) as a torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype_name(dtype)
    if name not in DTYPES:
        raise MXNetError(f"unknown dtype {dtype!r}")
    return DTYPES[name]


def to_numpy(a):
    """Host numpy copy of an NDArray, a tensor or an array-like
    (bfloat16 comes back as float32)."""
    a = getattr(a, "_data", a)
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return _np.asarray(a)


# -- attribute (parameter) parsing: dmlc::Parameter's string marshalling ---

def parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, _np.integer)):
        return bool(v)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0"):
            return False
    raise MXNetError(f"cannot parse bool from {v!r}")


def parse_int(v) -> int:
    if isinstance(v, str):
        return int(v.strip())
    return int(v)


def parse_float(v) -> float:
    if isinstance(v, str):
        return float(v.strip())
    return float(v)


def parse_shape(v):
    """(3,3), [3,3], "(3, 3)", "3", 3 -> tuple of int."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, (int, _np.integer)):
        return (int(v),)
    if isinstance(v, str):
        s = v.strip()
        if s in ("None", "()"):
            return () if s == "()" else None
        val = ast.literal_eval(s)
        if isinstance(val, (tuple, list)):
            return tuple(int(x) for x in val)
        return (int(val),)
    raise MXNetError(f"cannot parse shape from {v!r}")


def attr_to_string(v) -> str:
    """An attr value as MXNet's JSON writes it (str() of the value)."""
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(str(int(x)) if isinstance(x, (int, _np.integer))
                               else str(x) for x in v) + ")"
    return str(v)


# -- naming and attribute scopes (python/mxnet/name.py, attribute.py) -----

class NameManager:
    """Automatic unique names (python/mxnet/name.py): the first block or
    symbol of a kind without a name is ``dense0``, then ``dense1``, ...
    Counters are per thread and per manager; ``with NameManager():``
    starts a fresh count. Gluon blocks and symbols share the current
    manager, as in the JAX package."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name is not None:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old

    @classmethod
    def current(cls) -> "NameManager":
        v = getattr(cls._current, "value", None)
        if v is None:
            v = NameManager()
            cls._current.value = v
        return v


class AttrScope:
    """Scope of symbol attributes (python/mxnet/attribute.py): symbols
    created inside ``with AttrScope(ctx_group="a"):`` carry them."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._attrs = {k: str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attrs):
        cur = dict(self._attrs)
        if attrs:
            cur.update(attrs)
        return cur

    def __enter__(self):
        self._old = getattr(AttrScope._current, "value", None)
        merged = dict(self._old._attrs) if self._old is not None else {}
        merged.update(self._attrs)
        self._attrs = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old

    @classmethod
    def current(cls) -> "AttrScope":
        v = getattr(cls._current, "value", None)
        if v is None:
            v = AttrScope()
            cls._current.value = v
        return v
