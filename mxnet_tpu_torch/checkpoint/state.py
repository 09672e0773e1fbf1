"""Capture and restore of the full training state (counterpart of
mxnet_tpu/checkpoint/state.py).

A ``TrainingState`` holds what a training loop needs for a bit-identical
continuation: the parameters and aux states (fp32 masters), the
optimizer's states (momenta, mean/var, fp32 masters under
``multi_precision``) with the optimizer itself (its update counts: Adam's
bias correction needs the exact t), a fused trainer's device scalars (t,
the fp16 loss scaler), the epoch/batch cursor and the random state.

Capture copies. JAX arrays are immutable, so the JAX package's capture
holds references; here parameters, optimizer states and a captured
graph's buffers are updated in place, and a reference would pick up the
next steps. A tensor on the card is copied on the card (``clone``, on
the capturing thread's stream, a few ms for the GPT-2-medium LM's 4.3 GB
of parameters and Adam states) and an event recorded after the copies;
the saver thread moves the copies to the host on a stream of its own
that waits for that event alone, so the training steps queued meanwhile
are not waited for. Host tensors are cloned.

On disk (the commit protocol is ``manager.py``'s):
  arrays    -> the reference NDArray container (``arrays.nd``), which
               both packages read; names prefixed ``param:`` / ``aux:`` /
               ``opt:``. A dtype the container has no flag for (bfloat16)
               goes into the port's own ``arrays.raw`` (a JSON index and
               the raw bytes). The JAX package writes such arrays into a
               pickle of ``ml_dtypes`` arrays (``arrays.pkl``), which the
               port refuses, naming the dtype.
  optimizer -> ``optimizer.bin``, ``Updater.get_states(dump_optimizer=
               True)``'s bytes: pickled under the JAX package's names, so
               either package's ``Updater.set_states`` reads them.
  meta      -> JSON in the commit's TOPOLOGY.json (cursor, amp, trainer
               scalars). ``meta["rng"]`` is the JAX package's key and the
               port writes None there (that restore reshapes it into a
               key); the port's generators go under ``meta["torch_rng"]``.
"""
from __future__ import annotations

import copy
import json
import pickle
import struct

import numpy as _np
import torch

from ..base import MXNetError

_PARAM = "param:"
_AUX = "aux:"
_RAW_MAGIC = b"MXTRAW1\n"
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")


# -- host payloads ------------------------------------------------------------

def _raw_bytes(a):
    """(dtype name, shape, bytes) of a host array or tensor: the bytes of
    a bfloat16 tensor are its 16-bit words, as ``ml_dtypes`` keeps them."""
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        name = str(a.dtype).replace("torch.", "")
        if a.dtype == torch.bfloat16:
            data = a.view(torch.int16).numpy().tobytes()
        else:
            data = a.numpy().tobytes()
        return name, tuple(a.shape), data
    a = _np.ascontiguousarray(a)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def _as_numpy(a):
    """numpy for every dtype numpy holds; a bfloat16 tensor stays one."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a if a.dtype == torch.bfloat16 else a.numpy()
    return _np.asarray(a)


def _encode_arrays(host):
    """(fname, bytes) for a {name: host array} dict: the reference
    container when every dtype has a type flag, else ``arrays.raw``."""
    from ..ndarray.container import _DTYPE_TO_FLAG, container_bytes
    host = {k: _as_numpy(v) for k, v in host.items()}
    if all(isinstance(a, _np.ndarray) and a.dtype in _DTYPE_TO_FLAG
           for a in host.values()):
        return "arrays.nd", container_bytes(host)
    index, blobs, off = [], [], 0
    for name, a in host.items():
        dt, shape, data = _raw_bytes(a)
        index.append({"name": name, "dtype": dt, "shape": list(shape),
                      "offset": off, "nbytes": len(data)})
        blobs.append(data)
        off += len(data)
    head = json.dumps(index).encode("utf-8")
    return "arrays.raw", b"".join([_RAW_MAGIC, struct.pack("<Q", len(head)),
                                   head] + blobs)


def _decode_raw(payload):
    if not payload.startswith(_RAW_MAGIC):
        raise MXNetError("checkpoint: arrays.raw has no header")
    n = len(_RAW_MAGIC)
    (hlen,) = struct.unpack("<Q", payload[n:n + 8])
    base = n + 8 + hlen
    out = {}
    for e in json.loads(payload[n + 8:base].decode("utf-8")):
        data = payload[base + e["offset"]:base + e["offset"] + e["nbytes"]]
        if e["dtype"] == "bfloat16":
            t = torch.frombuffer(bytearray(data), dtype=torch.int16)
            out[e["name"]] = t.view(torch.bfloat16).reshape(e["shape"])
        else:
            out[e["name"]] = _np.frombuffer(data, dtype=e["dtype"]) \
                .reshape(e["shape"]).copy()
    return out


class _ArrayUnpickler(pickle.Unpickler):
    """Reads the JAX package's ``arrays.pkl`` (a pickle of {name: numpy
    array}) when numpy holds every dtype; an ``ml_dtypes`` dtype
    (bfloat16 and its kin) has no numpy counterpart here and is refused
    by name, as is any other class."""

    def find_class(self, module, name):
        if module in _NUMPY_MODULES or (module == "builtins"
                                        and name in ("dict", "list")):
            return super().find_class(module, name)
        if module.split(".")[0] == "ml_dtypes":
            raise MXNetError(
                f"checkpoint: arrays.pkl holds {name} arrays (ml_dtypes), "
                "which the JAX package writes for dtypes the NDArray "
                "container has no flag for; the port reads such arrays "
                "from its own arrays.raw only (ROADMAP queue 1 item 14: "
                "bfloat16 payloads across the packages)")
        raise MXNetError(f"checkpoint: arrays.pkl names {module}.{name}, "
                         "which is not a numpy array")


def _decode_arrays(fname, payload):
    """Inverse of _encode_arrays for one validated payload (and the JAX
    package's ``arrays.pkl``)."""
    if fname == "arrays.nd":
        from ..ndarray.container import _read_container_dense
        out = _read_container_dense(payload)
        if not isinstance(out, dict):
            raise MXNetError("checkpoint: arrays.nd holds no names")
        return out
    if fname == "arrays.raw":
        return _decode_raw(payload)
    import io
    return _ArrayUnpickler(io.BytesIO(payload)).load()


_PAYLOADS = ("arrays.nd", "arrays.raw", "arrays.pkl")


# -- capture ------------------------------------------------------------------

def _copy_tree(obj):
    """A copy of a state tree: every tensor and NDArray cloned on its
    device (in place updates of the live ones leave it alone)."""
    from ..ndarray.ndarray import NDArray
    if isinstance(obj, NDArray):
        return NDArray(obj._data.detach().clone())
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, tuple):
        return tuple(_copy_tree(x) for x in obj)
    if isinstance(obj, list):
        return [_copy_tree(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _copy_tree(v) for k, v in obj.items()}
    return obj


def _tensors(obj):
    from ..ndarray.ndarray import NDArray
    if isinstance(obj, NDArray):
        yield obj._data
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _host(v):
    """A host array of an NDArray, tensor or numpy array (no sync for
    host tensors: the capture's event was waited for first)."""
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        return _as_numpy(t.detach().cpu())
    return _np.asarray(t)


class TrainingState:
    """One checkpointable snapshot. ``arrays`` maps prefixed names
    (``param:`` / ``aux:`` / ``opt:``) to arrays (copies when captured
    from a live trainer); ``opt_states`` and ``optimizer`` (a copy) become
    ``optimizer.bin`` on the saver thread; ``meta`` is the JSON-safe
    cursor / random state / amp record. States loaded from disk carry
    ``.step`` and ``.metric``."""

    def __init__(self, arrays=None, opt_states=None, optimizer=None,
                 meta=None, opt_bytes=None):
        self.arrays = dict(arrays or {})
        self.opt_states = opt_states
        self.optimizer = optimizer
        self._opt_bytes = opt_bytes
        self.meta = dict(meta or {})
        self.step = self.meta.get("step")
        self.metric = None
        # the copies on a card were enqueued on the capturing thread's
        # stream: the saver waits for this event, not for later steps
        self._ready = {}
        for t in _tensors((self.arrays, opt_states)):
            if t.is_cuda and t.device not in self._ready:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                self._ready[t.device] = ev

    # -- serialization (the saver thread's side) -----------------------------
    def _to_host(self):
        """Move the card's copies to the host on a side stream that waits
        for the capture's event (once; the arrays become host arrays)."""
        if not self._ready:
            return
        for dev, ev in self._ready.items():
            stream = torch.cuda.Stream(dev)
            stream.wait_event(ev)
            with torch.cuda.stream(stream):
                self.arrays = {k: (v.to("cpu") if isinstance(v, torch.Tensor)
                                   and v.device == dev else v)
                               for k, v in self.arrays.items()}
                if self.opt_states is not None:
                    self.opt_states = _to_cpu_tree(self.opt_states, dev)
            stream.synchronize()
        self._ready = {}

    def optimizer_bytes(self):
        """``Updater.set_states``' bytes: (states, optimizer) when the
        optimizer was captured, else the states alone, pickled under the
        JAX package's names (``optimizer._dump_states``)."""
        if self._opt_bytes is not None:
            return self._opt_bytes
        if self.opt_states is None:
            return None
        self._to_host()
        from ..optimizer import _dump_states
        self._opt_bytes = _dump_states(self.opt_states, self.optimizer)
        return self._opt_bytes

    def host_arrays(self):
        """{name: host array} (bfloat16 as a tensor)."""
        self._to_host()
        return {k: _host(v) for k, v in self.arrays.items()}

    def to_shard_files(self, num_shards, ownership=None):
        """The snapshot partitioned into ``num_shards`` shard file lists,
        and the array -> shard map of TOPOLOGY.json (the JAX package's
        placement): arrays named in ``ownership`` ({name: shard}) whole in
        their shard; others split on axis 0 when it divides evenly
        ("split0", part k in shard k), else whole, round-robin by sorted
        name ("whole"). The optimizer's bytes go into shard 0. Returns
        (files_per_shard, shard_map)."""
        num_shards = max(1, int(num_shards))
        owned = {}
        for name, k in (ownership or {}).items():
            try:
                k = int(k)
            except (TypeError, ValueError):
                continue
            if 0 <= k < num_shards:
                owned[name] = k
        host = self.host_arrays()
        shard_arrays = [dict() for _ in range(num_shards)]
        shard_map = {}
        rr = 0
        for name in sorted(host):
            a = host[name]
            if name in owned:
                k = owned[name]
                shard_arrays[k][name] = a
                shard_map[name] = {"mode": "whole", "shard": k}
            elif num_shards > 1 and a.ndim >= 1 \
                    and a.shape[0] >= num_shards \
                    and a.shape[0] % num_shards == 0:
                n = a.shape[0] // num_shards
                for k in range(num_shards):
                    shard_arrays[k][name] = a[k * n:(k + 1) * n]
                shard_map[name] = {"mode": "split0"}
            else:
                k = rr % num_shards
                rr += 1
                shard_arrays[k][name] = a
                shard_map[name] = {"mode": "whole", "shard": k}
        files = []
        for k in range(num_shards):
            fs = []
            if shard_arrays[k]:
                fs.append(_encode_arrays(shard_arrays[k]))
            if k == 0:
                ob = self.optimizer_bytes()
                if ob is not None:
                    fs.append(("optimizer.bin", ob))
            files.append(fs)
        return files, shard_map

    @classmethod
    def from_shard_blobs(cls, shard_blobs, topology):
        """The logical snapshot from validated per-shard blobs (a list in
        shard order of {fname: bytes}) and the decoded TOPOLOGY.json:
        split arrays concatenated back on axis 0, host arrays a trainer's
        import places on the current devices."""
        shard_map = topology.get("shard_map") or {}
        per_shard = []
        for blobs in shard_blobs:
            decoded = {}
            for fname in _PAYLOADS:
                if fname in blobs:
                    decoded = _decode_arrays(fname, blobs[fname])
            per_shard.append(decoded)
        arrays = {}
        for name, place in shard_map.items():
            if place.get("mode") == "split0":
                parts = [s[name] for s in per_shard if name in s]
                if len(parts) != len(per_shard):
                    raise ValueError(
                        f"checkpoint: split array {name!r} has "
                        f"{len(parts)}/{len(per_shard)} parts")
                arrays[name] = torch.cat(parts) \
                    if isinstance(parts[0], torch.Tensor) \
                    else _np.concatenate(parts, axis=0)
            else:
                arrays[name] = per_shard[int(place["shard"])][name]
        st = cls(arrays=arrays, meta=topology.get("meta") or {},
                 opt_bytes=shard_blobs[0].get("optimizer.bin")
                 if shard_blobs else None)
        st.step = int(topology.get("step", st.meta.get("step", 0) or 0))
        st.metric = topology.get("metric")
        return st

    @classmethod
    def from_files(cls, blobs, manifest):
        """From validated {fname: bytes} and a format-1 MANIFEST."""
        arrays = {}
        for fname in _PAYLOADS:
            if fname in blobs:
                arrays = _decode_arrays(fname, blobs[fname])
        st = cls(arrays=arrays, meta=manifest.get("meta") or {},
                 opt_bytes=blobs.get("optimizer.bin"))
        st.step = int(manifest.get("step", st.meta.get("step", 0) or 0))
        st.metric = manifest.get("metric")
        return st

    # -- restore-side views --------------------------------------------------
    def _nd_dict(self, prefix):
        from ..ndarray.ndarray import NDArray
        from ..executor import _from_numpy
        out = {}
        for k, v in self.host_arrays().items():
            if k.startswith(prefix):
                t = v if isinstance(v, torch.Tensor) else _from_numpy(v)
                out[k[len(prefix):]] = NDArray(t)
        return out

    def arg_params_nd(self):
        return self._nd_dict(_PARAM)

    def aux_params_nd(self):
        return self._nd_dict(_AUX)


def _to_cpu_tree(obj, dev):
    from ..ndarray.ndarray import NDArray
    if isinstance(obj, NDArray):
        t = obj._data
        return NDArray(t.to("cpu")) if t.device == dev else obj
    if isinstance(obj, torch.Tensor):
        return obj.to("cpu") if obj.device == dev else obj
    if isinstance(obj, tuple):
        return tuple(_to_cpu_tree(x, dev) for x in obj)
    if isinstance(obj, list):
        return [_to_cpu_tree(x, dev) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_cpu_tree(v, dev) for k, v in obj.items()}
    return obj


def state_sha256(state):
    """Content hash of a snapshot, equal across shard counts and across
    the two packages: every array sorted by name (name, dtype, shape, raw
    bytes), the optimizer's bytes, and the fused trainer's t and loss
    scaler."""
    import hashlib
    h = hashlib.sha256()
    host = state.host_arrays()
    for name in sorted(host):
        dt, shape, data = _raw_bytes(host[name])
        h.update(name.encode("utf-8"))
        h.update(dt.encode("utf-8"))
        h.update(repr(shape).encode("utf-8"))
        h.update(data)
    ob = state.optimizer_bytes()
    if ob is not None:
        h.update(ob)
    tmeta = state.meta.get("trainer") or {}
    for k in ("t", "loss_scaler"):
        if tmeta.get(k) is not None:
            h.update(repr(tmeta[k]).encode("utf-8"))
    return h.hexdigest()


def rescale_cursor(meta, new_batch_size):
    """The saved mid-epoch batch cursor on the current global batch: the
    resumed run skips the same number of samples, not of batches (rounded
    down: a boundary that does not divide replays at most one partial
    batch). Equal or unrecorded batch sizes keep the cursor."""
    batch = int(meta.get("batch", 0) or 0)
    old = meta.get("batch_size")
    if not old or not new_batch_size or int(old) == int(new_batch_size):
        return batch
    return (batch * int(old)) // int(new_batch_size)


def _meta(kind, epoch, batch, step, amp_dtype=None):
    """The cursor / random state / amp record of a capture."""
    from .. import amp as _amp
    from .. import random as _random
    if amp_dtype is None and _amp.is_enabled():
        amp_dtype = _amp.get_dtype()
    return {"kind": kind, "epoch": int(epoch), "batch": int(batch),
            "step": int(step), "rng": None,
            "torch_rng": _random.get_state(),
            "amp_dtype": amp_dtype if amp_dtype != "float32" else None}


def restore_rng(meta, logger=None):
    """The port's generators from ``meta["torch_rng"]``; a JAX key under
    ``meta["rng"]`` cannot seed them and is ignored, with a warning."""
    from .. import random as _random
    if meta.get("torch_rng") is not None:
        _random.set_state(meta["torch_rng"])
    elif meta.get("rng") is not None:
        import logging
        (logger or logging).warning(
            "checkpoint: the random state under 'rng' is the JAX package's "
            "key, which does not seed the port's generators; ignored")


# -- Module (the per-batch fit) ----------------------------------------------

def _updater_of(module):
    """The live Updater of a Module: its own, or the kvstore's when the
    kvstore updates (as ``Module.save_optimizer_states`` chooses)."""
    if getattr(module, "_update_on_kvstore", False) \
            and getattr(module, "_kvstore", None) is not None:
        return module._kvstore._updater
    return getattr(module, "_updater", None)


def _optimizer_copy(upd):
    return copy.deepcopy(upd.optimizer) \
        if upd is not None and upd.optimizer is not None else None


def capture_module_state(module, epoch, batch=0, step=0, batch_size=None):
    """Snapshot a bound, initialized Module in the middle of a fit.
    ``epoch`` / ``batch`` are the cursor to resume at (the first epoch and
    batch the restored run executes)."""
    args, auxs = module.get_params()
    arrays = {}
    for k, v in args.items():
        arrays[_PARAM + k] = _copy_tree(v)._data
    for k, v in auxs.items():
        arrays[_AUX + k] = _copy_tree(v)._data
    upd = _updater_of(module)
    meta = _meta("module", epoch, batch, step)
    if batch_size is not None:
        meta["batch_size"] = int(batch_size)
    return TrainingState(
        arrays=arrays,
        opt_states=_copy_tree(upd.states) if upd is not None else None,
        optimizer=_optimizer_copy(upd), meta=meta)


def restore_module_state(module, state, logger=None):
    """Re-arm a bound, initialized Module from a snapshot: the optimizer's
    states (fp32 masters and update counts included) and the random
    state. Parameters and aux go through ``init_params``
    (``arg_params_nd()`` / ``aux_params_nd()``)."""
    upd = _updater_of(module)
    ob = state.optimizer_bytes()
    if upd is not None and ob is not None:
        upd.set_states(ob)
        if upd.optimizer is not None and hasattr(module, "_optimizer"):
            module._optimizer = upd.optimizer
    restore_rng(state.meta, logger)


# -- Gluon Trainer (the imperative loop) --------------------------------------

def _trainer_updater(trainer):
    if not trainer._kv_initialized:
        trainer._init_kvstore()
    return trainer._kvstore._updater if trainer._update_on_kvstore \
        else trainer._updaters[0]


def capture_trainer_state(trainer, epoch=0, batch=0, step=0):
    """Snapshot a Gluon Trainer and its Parameters: their data, the
    updater's states (fp32 masters under multi_precision), the optimizer
    (its update counts) and the random state."""
    arrays = {_PARAM + p.name: p.list_data()[0]._data.detach().clone()
              for p in trainer._params}
    upd = _trainer_updater(trainer)
    return TrainingState(arrays=arrays, opt_states=_copy_tree(upd.states),
                         optimizer=_optimizer_copy(upd),
                         meta=_meta("gluon_trainer", epoch, batch, step))


def restore_trainer_state(trainer, state, logger=None):
    """Re-arm a Gluon Trainer from a snapshot: each Parameter present in
    it (``set_data``), the optimizer's states and counts in every updater,
    and the random state."""
    args = state.arg_params_nd()
    for p in trainer._params:
        if p.name in args:
            p.set_data(args[p.name])
    ob = state.optimizer_bytes()
    if ob is not None:
        _trainer_updater(trainer)
        if trainer._update_on_kvstore:
            trainer._kvstore._updater.set_states(ob)
            trainer._optimizer = trainer._kvstore._updater.optimizer
        else:
            for updater in trainer._updaters:
                updater.set_states(ob)
                updater.optimizer = trainer._updaters[0].optimizer
            trainer._optimizer = trainer._updaters[0].optimizer
        trainer._optimizer.param_dict = {
            i: param for i, param in enumerate(trainer._params)}
    restore_rng(state.meta, logger)


# -- DataParallelTrainer (the fused fits) -------------------------------------

def capture_fused_state(trainer, params, states, aux, kind, epoch, batch,
                        step, batch_size, dtype):
    """Snapshot a fused fit: the trainer's state (copies on its device),
    its t and fp16 scaler, and the cursor."""
    arrays, tmeta = trainer.export_training_state(params, states, aux)
    meta = _meta(kind, epoch, batch, step, amp_dtype=dtype)
    meta.update(batch_size=int(batch_size), trainer=tmeta)
    return TrainingState(arrays=arrays, meta=meta)
