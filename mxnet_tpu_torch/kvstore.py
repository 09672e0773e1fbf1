"""KVStore — the parameter synchronization facade (counterpart of
mxnet_tpu/kvstore.py), in one process.

  - ``init(key, value)`` stores a copy; initialising a key twice raises;
  - ``push(key, vals)`` sums the values (one a device) onto the first
    value's device (the reference's CommDevice::Reduce); with an updater
    set the merged value updates the stored weight, else it replaces it;
  - ``pull(key, out)`` writes the stored value into each out array, on
    that array's device;
  - ``set_gradient_compression({"type": "2bit", "threshold": t})``
    quantizes each merged push to the reference's packed 2-bit wire
    format with an error-feedback residual (``quantize_2bit``, in torch,
    bit for bit the JAX package's words).

Kinds: ``local``, ``device``, ``nccl`` and ``local_allreduce_cpu`` /
``local_allreduce_device`` are this single-process store (as in the JAX
package, where the data-parallel step itself sums the gradients and this
store serves code that drives a kvstore explicitly). The ``dist*`` kinds
need a process group (``dist.py``, ROADMAP queue 1 item 16) and raise.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from .base import MXNetError
from . import optimizer as opt

__all__ = ["KVStore", "create", "quantize_2bit", "dequantize_2bit"]

_KINDS = ("local", "device", "nccl", "local_allreduce_cpu",
          "local_allreduce_device", "dist_sync", "dist_async",
          "dist_device_sync", "dist_sync_device", "dist")


class KVStore:
    """Single-process key-value store with a multi-device reduce."""

    def __init__(self, kind="local"):
        if "dist" in kind:
            raise MXNetError(f"kvstore {kind!r} needs a process group, which "
                             "is not ported yet (ROADMAP queue 1 item 16)")
        self._kind = kind
        self._store = {}        # str key -> NDArray (the canonical copy)
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._residuals = {}    # error-feedback state per key (2bit)
        self._str_key_int = {}  # str key -> stable int (updater index)
        if "async" in kind:
            logging.warning(
                "kvstore %r: async parameter-server mode has no "
                "single-process analog; running synchronously", kind)

    # -- identity -----------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core ---------------------------------------------------------------
    @staticmethod
    def _key_list(key, vals):
        """(key, vals) -> ([str key], [list of NDArray])."""
        single = not isinstance(key, (list, tuple))
        keys = [str(k) for k in ([key] if single else key)]
        if single:
            vlists = [vals if isinstance(vals, (list, tuple)) else [vals]]
        else:
            if len(vals) != len(keys):
                raise MXNetError(f"{len(keys)} keys but {len(vals)} values")
            vlists = [v if isinstance(v, (list, tuple)) else [v]
                      for v in vals]
        return keys, vlists

    def init(self, key, value):
        keys, vlists = self._key_list(key, value)
        for k, vlist in zip(keys, vlists):
            if k in self._store:
                raise MXNetError(f"key {k!r} already initialized")
            self._str_key_int.setdefault(k, len(self._str_key_int))
            self._store[k] = vlist[0].copy()

    @staticmethod
    def _reduce(vlist):
        """The values summed onto the first value's device, in list
        order."""
        acc = vlist[0].copy()
        for v in vlist[1:]:
            acc += v.as_in_context(acc.context)
        return acc

    def push(self, key, value, priority=0):
        keys, vlists = self._key_list(key, value)
        for k, vlist in zip(keys, vlists):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            merged = self._reduce(vlist)
            if self._compression is not None:
                merged = self._compress(k, merged)
            stored = self._store[k]
            if self._updater is not None:
                self._updater(self._str_key_int[k],
                              merged.as_in_context(stored.context), stored)
            else:
                self._store[k] = merged.as_in_context(stored.context)

    def _compress(self, k, merged):
        """The merged value through the packed 2-bit wire format, with the
        quantization error carried in the key's residual."""
        from .ndarray.ndarray import NDArray
        threshold = float(self._compression.get("threshold", 0.5))
        vals = merged._data
        if k not in self._residuals:
            self._residuals[k] = torch.zeros(vals.shape, dtype=torch.float32,
                                             device=vals.device)
        packed, self._residuals[k] = quantize_2bit(
            vals, self._residuals[k], threshold)
        decomp = dequantize_2bit(packed, vals.numel(), threshold)
        return NDArray(decomp.reshape(vals.shape).to(vals.dtype))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, olists = self._key_list(key, out)
        for k, olist in zip(keys, olists):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            for o in olist:
                self._store[k].copyto(o)

    # -- optimizer ----------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store, on each push."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit compression of each push (``{"type": "2bit",
        "threshold": t}``); any other type raises."""
        self._compression = dict(compression_params)
        if self._compression.get("type", "2bit") != "2bit":
            raise MXNetError("only 2bit compression is supported")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("updater is not initialized")
        from .base import atomic_write
        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("updater is not initialized")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def create(name="local"):
    """A KVStore of kind ``name`` (the JAX package's list of kinds)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _KINDS:
        raise MXNetError(f"unknown kvstore type {name!r}")
    return KVStore(name)


# -- packed 2-bit gradient compression wire format --------------------------
# (gradient_compression-inl.h:40-120): element j of a 16-element block sits
# in bits (31-2*(j%16), 30-2*(j%16)) of word j//16; 11 = +threshold,
# 10 = -threshold, 00 = below threshold. The words travel as float32 bit
# patterns, as in the JAX package.

_SHIFTS = 30 - 2 * torch.arange(16, dtype=torch.int64)


def quantize_2bit(arr, residual, threshold):
    """(packed words as float32 bit patterns, new residual) of ``arr`` +
    ``residual`` against ``threshold``; the words are the JAX package's
    ``quantize_2bit`` bit for bit. Tensors or numpy arrays in, tensors
    out (on ``arr``'s device)."""
    arr = torch.as_tensor(_np.asarray(arr) if not isinstance(
        arr, torch.Tensor) else arr)
    residual = torch.as_tensor(_np.asarray(residual) if not isinstance(
        residual, torch.Tensor) else residual).to(arr.device)
    t = torch.tensor(threshold, dtype=torch.float32)
    flat = arr.to(torch.float32).reshape(-1) + residual.reshape(-1) \
        .to(torch.float32)
    pos = flat >= t
    neg = flat <= -t
    new_res = flat - t * pos + t * neg
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    n = flat.numel()
    nw = (n + 15) // 16
    padded = torch.zeros(nw * 16, dtype=torch.int64, device=flat.device)
    padded[:n] = codes
    words = (padded.reshape(nw, 16) << _SHIFTS.to(flat.device)).sum(1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return (words.to(torch.int32).view(torch.float32),
            new_res.reshape(residual.shape))


def dequantize_2bit(packed, orig_size, threshold):
    """The inverse of :func:`quantize_2bit`: ``orig_size`` float32
    values of +threshold, -threshold or 0."""
    packed = torch.as_tensor(_np.asarray(packed) if not isinstance(
        packed, torch.Tensor) else packed)
    words = packed.contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    codes = ((words[:, None] >> _SHIFTS.to(words.device)) & 3) \
        .reshape(-1)[:orig_size]
    t = torch.tensor(threshold, dtype=torch.float32, device=words.device)
    return torch.where(codes == 3, t, torch.where(
        codes == 2, -t, torch.zeros((), dtype=torch.float32,
                                    device=words.device)))
