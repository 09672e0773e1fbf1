"""ModelRouter — many hot .mxa models behind one name table, within the
card's memory (counterpart of mxnet_tpu/serving/router.py).

A serving process fronts MANY models but one device memory. The router
owns the name -> EnginePool table and makes the memory call:

  - **Admission** (``load``): before the artifact is opened, the model's
    footprint is ESTIMATED from its manifest (``manifest_need_bytes``: the
    ``devstats`` block's ``peak_bytes``, measured at export on the card,
    else the size of ``params.bin``) times the replica count, and checked
    against the budget by ``telemetry.devstats.preflight``. A model whose
    estimate alone exceeds the whole budget is rejected outright (HTTP
    507 at the frontend) without evicting anything and without a plan
    entering any cache. The budget is ``budget``, else
    ``MXNET_SERVING_HBM_BUDGET``, else ``devstats.hbm_budget`` of the
    router's device (``MXNET_DEVSTATS_HBM_BYTES``, else the card's total
    memory; none on the CPU).
  - **Eviction**: when the estimate fits the budget but not the current
    headroom, least-recently-USED models are unloaded, each charged its
    *measured* ``plan_resident_bytes`` summed over its replicas, until
    the new model fits. ``MXNET_SERVING_MAX_MODELS`` bounds the table by
    count the same way (0 = unbounded).
  - **Routing** (``predict``): name -> pool lookup, LRU touch,
    least-loaded replica dispatch. Unknown names raise ``UnknownModel``
    (HTTP 404). Decode artifacts sit in the same table behind
    ``generate`` (the port's DecodeEngine).

Concurrency: ONE lock guards the table. Loads insert a LOADING
placeholder under the lock, build the pool OUTSIDE it, then flip the
placeholder to READY; a concurrent load of the same name waits on the
placeholder's event. Evicted pools are closed outside the lock too.
"""
from __future__ import annotations

import io
import json
import os
import threading
import zipfile

from .pool import EnginePool
from ..telemetry import devstats

__all__ = ["ModelRouter", "UnknownModel", "manifest_need_bytes"]


class UnknownModel(KeyError):
    """predict()/unload() against a name the router does not hold."""


def manifest_need_bytes(path):
    """Estimated per-replica HBM need of a .mxa artifact, WITHOUT
    loading it: the export-time devstats `peak_bytes` when the manifest
    carries it, else the parameter blob size (weights must at least be
    resident), else the file size."""
    try:
        with zipfile.ZipFile(path) as zf:
            try:
                with io.TextIOWrapper(zf.open("MANIFEST.json"),
                                      encoding="utf-8") as f:
                    man = json.load(f)
                peak = int((man.get("devstats") or {}).get("peak_bytes")
                           or 0)
                if peak > 0:
                    return peak
            except KeyError:
                pass
            for info in zf.infolist():
                if info.filename.endswith("params.bin"):
                    return int(info.file_size)
    except (OSError, zipfile.BadZipFile):
        pass
    try:
        return int(os.path.getsize(path))
    except OSError:
        return 0


def _manifest_decode_block(path):
    """The manifest `decode` block when `path` is a decode artifact
    (contrib.export.export_decode_model), else None."""
    try:
        with zipfile.ZipFile(path) as zf:
            with io.TextIOWrapper(zf.open("MANIFEST.json"),
                                  encoding="utf-8") as f:
                return json.load(f).get("decode")
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


class _DecodeAdapter:
    """Pool-shaped wrapper around one DecodeEngine so decode artifacts
    sit in the same name table as predict pools. A decode engine is its
    own concurrency domain (the KV-slot pool), so the router's replica
    knob does not apply — one engine per name. `submit` (the predict
    path) is refused with a 400-mapping error; `generate` is the
    entry point."""

    def __init__(self, path, name=None, device=None):
        from .decode import DecodeEngine
        self.engine = DecodeEngine(path, name=name, device=device)

    def submit(self, *arrays, timeout_ms=None, priority="interactive"):
        raise ValueError("decode model: POST :generate, not :predict")

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 timeout_ms=None):
        return self.engine.submit(tokens, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, timeout_ms=timeout_ms)

    def resident_bytes(self):
        return self.engine.resident_bytes()

    def stats(self):
        st = self.engine.stats()
        st["decode"] = True
        return st

    def close(self, drain=True):
        self.engine.close(drain=drain)


class _Entry:
    __slots__ = ("path", "pool", "need", "last_used", "ready", "error")

    def __init__(self, path, need):
        self.path = path
        self.pool = None            # None while LOADING
        self.need = need            # admission-time estimate (bytes)
        self.last_used = 0
        self.ready = threading.Event()
        self.error = None           # load failure, for concurrent waiters


class ModelRouter:
    """Name table of hot models with HBM-budgeted LRU admission.

    Parameters
    ----------
    budget : device-memory budget in bytes; None reads
        MXNET_SERVING_HBM_BUDGET, falling back to devstats.hbm_budget()
        of ``device`` (None = unbudgeted).
    device : where the models are served (default: the card).
    max_models : table size bound (0 = unbounded).
    replicas : EnginePool replica count per model.
    pool_factory : replaces EnginePool construction (tests inject
        fakes); called as `pool_factory(path, replicas=r)`.
    need_fn : replaces `manifest_need_bytes` (per-replica estimate).
    pool_kw : extra EnginePool kwargs (queue_depth, buckets, ...).
    """

    def __init__(self, budget=None, max_models=None, replicas=None,
                 pool_factory=None, need_fn=None, device=None, **pool_kw):
        from .. import config
        from ..context import resolve_device
        self.device = resolve_device(device)
        if budget is None:
            budget = config.get("MXNET_SERVING_HBM_BUDGET")
        if budget is None:
            budget = devstats.hbm_budget(self.device)
        self.budget = int(budget) if budget else None
        if max_models is None:
            max_models = config.get("MXNET_SERVING_MAX_MODELS")
        self.max_models = int(max_models or 0)
        if replicas is None:
            replicas = config.get("MXNET_SERVING_REPLICAS")
        self.replicas = max(1, int(replicas or 1))
        self._pool_factory = pool_factory
        self._need_fn = need_fn or manifest_need_bytes
        self._pool_kw = pool_kw
        self._lock = threading.Lock()
        self._models = {}           # name -> _Entry
        self._tick = 0              # LRU clock (monotonic counter)
        self._closed = False

    # -- internals (callers hold self._lock) ---------------------------------

    def _touch(self, entry):
        self._tick += 1
        entry.last_used = self._tick

    def _resident_locked(self):
        return sum(e.pool.resident_bytes() for e in self._models.values()
                   if e.pool is not None)

    def _pick_victims(self, need, incoming):
        """Choose LRU READY entries to evict so `need` more bytes fit
        the budget (and the table stays under max_models). Returns the
        victim names; caller pops + closes them. LOADING entries are
        never victims (their cost is unknown and a waiter holds them)."""
        victims = []
        if self.budget is None and not self.max_models:
            return victims
        ready = sorted(
            ((e.last_used, name) for name, e in self._models.items()
             if e.pool is not None and name != incoming),
            key=lambda t: t[0])
        resident = self._resident_locked()
        count = sum(1 for e in self._models.values())
        for _, name in ready:
            over_bytes = (self.budget is not None
                          and resident + need > self.budget)
            over_count = (self.max_models
                          and count + 1 > self.max_models)
            if not over_bytes and not over_count:
                break
            victims.append(name)
            resident -= self._models[name].pool.resident_bytes()
            count -= 1
        if self.budget is not None and resident + need > self.budget:
            # unfittable even with every READY model gone
            devstats.preflight(incoming, need, resident_bytes=resident,
                               budget=self.budget, what="serving model")
        if self.max_models and count + 1 > self.max_models:
            raise RuntimeError(
                f"model table full ({self.max_models}) and nothing "
                f"evictable")
        return victims

    def _build_pool(self, path):
        if self._pool_factory is not None:
            return self._pool_factory(path, replicas=self.replicas)
        if _manifest_decode_block(path) is not None:
            return _DecodeAdapter(path, device=self.device)
        return EnginePool(path, replicas=self.replicas, device=self.device,
                          **self._pool_kw)

    # -- public API ----------------------------------------------------------

    def load(self, name, path):
        """Hot-load `path` under `name`. Admission order is the
        contract: (1) whole-budget preflight on the manifest estimate —
        an over-budget model is rejected BEFORE eviction and BEFORE any
        plan enters any cache; (2) LRU eviction down to headroom;
        (3) pool build outside the lock. Returns the entry's stats."""
        name = str(name)
        need = int(self._need_fn(path)) * self.replicas
        # (1) the estimate alone must fit an empty device: a model that
        # can never fit must not evict everything else first
        devstats.preflight(name, need, resident_bytes=0,
                           budget=self.budget, what="serving model")
        victims = []
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            cur = self._models.get(name)
            if cur is not None:
                wait_for = cur
            else:
                wait_for = None
                for v in self._pick_victims(need, name):
                    victims.append((v, self._models.pop(v)))
                entry = _Entry(path, need)
                self._touch(entry)
                self._models[name] = entry
        for _, ve in victims:
            ve.pool.close()
        if wait_for is not None:
            # someone else holds/builds this name: wait, don't rebuild
            wait_for.ready.wait()
            if wait_for.error is not None:
                raise wait_for.error
            return self.stats(name)
        try:
            pool = self._build_pool(path)
        except BaseException as e:
            with self._lock:
                entry.error = e
                if self._models.get(name) is entry:
                    del self._models[name]
            entry.ready.set()
            raise
        with self._lock:
            # unload()/close() may have dropped the placeholder while we
            # compiled — the orphaned pool must not leak its workers
            orphaned = self._closed or self._models.get(name) is not entry
            if not orphaned:
                entry.pool = pool
                self._touch(entry)
        entry.ready.set()
        if orphaned:
            pool.close()
            raise RuntimeError(f"model {name!r} was unloaded during load")
        return self.stats(name)

    def predict(self, name, arrays, timeout_ms=None,
                priority="interactive"):
        """Route one request; returns the future from the least-loaded
        replica of `name`'s pool. UnknownModel when the name is absent
        (a LOADING entry is waited on, not 404'd)."""
        with self._lock:
            entry = self._models.get(str(name))
            if entry is not None and entry.pool is not None:
                self._touch(entry)
        if entry is None:
            raise UnknownModel(f"model {name!r} is not loaded")
        if entry.pool is None:
            entry.ready.wait()
            with self._lock:
                entry = self._models.get(str(name))
                if entry is None or entry.pool is None:
                    raise UnknownModel(f"model {name!r} is not loaded")
                self._touch(entry)
        fut, _ = entry.pool.submit(*arrays, timeout_ms=timeout_ms,
                                   priority=priority)
        return fut

    def generate(self, name, tokens, max_new_tokens=None, eos_id=None,
                 timeout_ms=None):
        """Route one autoregressive generation to a decode model;
        returns the engine's Session (future resolves to the token
        list). ValueError when the name holds a predict-only model
        (HTTP 400 at the frontend); UnknownModel when absent."""
        with self._lock:
            entry = self._models.get(str(name))
            if entry is not None and entry.pool is not None:
                self._touch(entry)
        if entry is None:
            raise UnknownModel(f"model {name!r} is not loaded")
        if entry.pool is None:
            entry.ready.wait()
            with self._lock:
                entry = self._models.get(str(name))
                if entry is None or entry.pool is None:
                    raise UnknownModel(f"model {name!r} is not loaded")
                self._touch(entry)
        gen = getattr(entry.pool, "generate", None)
        if gen is None:
            raise ValueError(f"model {name!r} is not a decode model "
                             "(use :predict)")
        return gen(tokens, max_new_tokens=max_new_tokens, eos_id=eos_id,
                   timeout_ms=timeout_ms)

    def unload(self, name):
        """Drop a model; its pool (and every compiled plan) is closed.
        UnknownModel when absent. A LOADING entry is waited out first so
        close() never races the build."""
        name = str(name)
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise UnknownModel(f"model {name!r} is not loaded")
        entry.ready.wait()
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is None:
            raise UnknownModel(f"model {name!r} is not loaded")
        if entry.pool is not None:
            entry.pool.close()

    def models(self):
        """Loaded names in LRU order (stalest first)."""
        with self._lock:
            return [name for _, name in sorted(
                (e.last_used, n) for n, e in self._models.items())]

    def resident_bytes(self):
        with self._lock:
            return self._resident_locked()

    def stats(self, name=None):
        """Stats for one model, or the full table + totals."""
        if name is not None:
            with self._lock:
                entry = self._models.get(str(name))
            if entry is None:
                raise UnknownModel(f"model {name!r} is not loaded")
            entry.ready.wait()
            if entry.pool is None:
                raise UnknownModel(f"model {name!r} is not loaded")
            st = entry.pool.stats()
            st["name"] = str(name)
            st["need_bytes"] = entry.need
            st["path"] = entry.path
            return st
        with self._lock:
            names = list(self._models)
        out = {"models": {}, "budget": self.budget,
               "max_models": self.max_models,
               "replicas": self.replicas}
        for n in names:
            with self._lock:
                e = self._models.get(n)
            if e is None:
                continue
            if e.pool is None:         # mid-load: report, don't block
                out["models"][n] = {"name": n, "loading": True,
                                    "need_bytes": e.need}
                continue
            try:
                out["models"][n] = self.stats(n)
            except UnknownModel:
                continue
        out["resident_bytes"] = self.resident_bytes()
        return out

    def close(self):
        """Idempotent; unloads everything."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e.ready.wait()
            if e.pool is not None:
                e.pool.close()

    __enter__ = lambda self: self

    def __exit__(self, *exc):
        self.close()
        return False
