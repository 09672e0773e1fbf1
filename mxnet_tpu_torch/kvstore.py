"""KVStore — the parameter synchronization facade (counterpart of
mxnet_tpu/kvstore.py), in one process.

  - ``init(key, value)`` stores a copy; initialising a key twice raises;
  - ``push(key, vals)`` sums the values (one a device) onto the first
    value's device (the reference's CommDevice::Reduce); with an updater
    set the merged value updates the stored weight, else it replaces it;
    row_sparse values (all of a push) merge instead: their rows
    deduplicated and summed (``sparse.merge_row_sparse``), so the
    updater's optimizer updates only those rows (its lazy path);
  - ``pull(key, out)`` writes the stored value into each out array, on
    that array's device; ``row_sparse_pull(key, out, row_ids)`` only the
    named rows, zeros elsewhere;
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

    def _reduce_row_sparse(self, k, vlist):
        """The row-sparse reduce (the reference's comm.h Reduce over
        kRowSparseStorage): every value's (rows, vals) concatenated,
        deduplicated and duplicate rows summed, on the stored value's
        device. The result keeps its parts, so the updater takes the
        optimizers' scatter path. 2-bit compression is skipped: the
        residual has no stable coordinates on a row set that changes
        every push."""
        from .ndarray import sparse as _sp
        stored = self._store[k]
        return _sp.merge_row_sparse(vlist, shape=stored.shape,
                                    ctx=stored.context)

    def push(self, key, value, priority=0):
        keys, vlists = self._key_list(key, value)
        for k, vlist in zip(keys, vlists):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            if all(getattr(v, "stype", "default") == "row_sparse"
                   for v in vlist):
                merged = self._reduce_row_sparse(k, vlist)
            else:
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

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names (kvstore_dist.h:260's
        row_sparse path), dense-backed: the other rows come back zero.
        ``row_ids`` lines up with the outputs of a single key (one for
        all of them, or one each), or holds one entry a key. Ids are
        deduplicated; an empty list pulls zeros; an id out of range
        (negative too) raises."""
        if out is None:
            raise MXNetError("row_sparse_pull requires out=")
        if row_ids is None:
            return self.pull(key, out=out, priority=priority)
        keys, olists = self._key_list(key, out)
        if not isinstance(key, (list, tuple)):
            rlists = [row_ids if isinstance(row_ids, (list, tuple))
                      else [row_ids]]
        else:
            rlists = list(row_ids) if isinstance(row_ids, (list, tuple)) \
                else [row_ids]
            if len(rlists) != len(keys):
                raise MXNetError(
                    f"row_sparse_pull: {len(keys)} keys but "
                    f"{len(rlists)} row_ids entries")
            rlists = [r if isinstance(r, (list, tuple)) else [r]
                      for r in rlists]
        for k, olist, rid_list in zip(keys, olists, rlists):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized")
            stored = self._store[k]._data
            if len(rid_list) == 1 and len(olist) > 1:
                rid_list = list(rid_list) * len(olist)
            if len(rid_list) != len(olist):
                raise MXNetError(
                    f"row_sparse_pull: key {k!r} has {len(olist)} outputs "
                    f"but {len(rid_list)} row_ids")
            for o, rid in zip(olist, rid_list):
                ids = torch.as_tensor(getattr(rid, "_data", rid)) \
                    .reshape(-1).to(device=stored.device, dtype=torch.int64)
                if ids.numel():
                    lo, hi = int(ids.min()), int(ids.max())
                    # checked before indexing: a negative id would wrap
                    if lo < 0 or hi >= stored.shape[0]:
                        raise MXNetError(
                            f"row_sparse_pull: row id out of range "
                            f"[0, {stored.shape[0]}) for key {k!r} (min "
                            f"{lo}, max {hi})")
                keep = torch.zeros(stored.shape[0], dtype=torch.bool,
                                   device=stored.device)
                keep[ids] = True
                masked = torch.where(
                    keep.reshape((-1,) + (1,) * (stored.ndim - 1)), stored,
                    torch.zeros((), dtype=stored.dtype,
                                device=stored.device))
                o._invalidate()
                with torch.no_grad():
                    o._data.copy_(masked)

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
