"""EnginePool — R ServingEngine replicas behind least-loaded dispatch
(counterpart of mxnet_tpu/serving/pool.py).

One engine serialises its plans behind its lock, so one ServingEngine
caps a model at one batch in flight. The pool runs ``replicas`` engines
over the same artifact on one device, each with its OWN plan cache (its
own CUDA graphs, captured on its own CUDA stream into its own pool), and
one DynamicBatcher per engine, so R batches can be in flight on the card
at once: the JAX pool's purpose (one replica a device there) on a single
card. The replicas share one Predictor (one copy of the params on the
device; the graphs only read them).

Dispatch is least-loaded: ``submit()`` reads every replica's live
``depth()`` (queued in both admission classes + taken-but-unresolved)
and routes to the emptiest queue, round-robin on ties. Each replica's
ServingMetrics carries ``model=<name>`` and ``replica=<i>`` labels;
``stats()`` aggregates the per-replica snapshots for the frontend, and
``resident_bytes()`` sums the plan caches: the number the ModelRouter's
LRU charges this model for.
"""
from __future__ import annotations

import threading

from .batcher import DynamicBatcher
from .engine import ServingEngine
from .metrics import ServingMetrics
from ..predictor import Predictor

__all__ = ["EnginePool"]


class EnginePool:
    """R ServingEngine replicas over one artifact, least-loaded dispatch.

    Parameters
    ----------
    model : path to a .mxa artifact (or anything ServingEngine accepts).
    replicas : number of engine replicas (>= 1).
    device : the device every replica serves on (default: the card).
    engine_factory : replaces ServingEngine construction (tests inject
        fakes); called as `engine_factory(model, replica=i)`.
    queue_depth / batch_queue_depth / max_wait_us / default_timeout_ms :
        per-replica DynamicBatcher knobs.
    engine_kw : extra ServingEngine kwargs (e.g. buckets=[1, 4, 8]).
    """

    def __init__(self, model, replicas=1, engine_factory=None,
                 queue_depth=64, batch_queue_depth=None, max_wait_us=2000,
                 default_timeout_ms=None, device=None, **engine_kw):
        self.replicas = max(1, int(replicas))
        self._rr = 0                    # round-robin tiebreak cursor
        self._lock = threading.Lock()   # guards _rr and close-once
        self._closed = False
        engines = []
        try:
            if engine_factory is None and not isinstance(model, Predictor):
                model = Predictor(model, device=device)
            for i in range(self.replicas):
                if engine_factory is not None:
                    engines.append(engine_factory(model, replica=i))
                else:
                    engines.append(ServingEngine(model, **engine_kw))
        except Exception:
            for e in engines:
                close = getattr(e, "close", None)
                if close:
                    close()
            raise
        self.engines = engines
        self.model_name = getattr(engines[0], "model_name", None)
        self.batchers = [
            DynamicBatcher(
                eng, max_wait_us=max_wait_us, queue_depth=queue_depth,
                batch_queue_depth=batch_queue_depth,
                default_timeout_ms=default_timeout_ms,
                metrics=ServingMetrics(
                    model=getattr(eng, "model_name", None), replica=i))
            for i, eng in enumerate(engines)]

    # -- dispatch ------------------------------------------------------------

    def _least_loaded(self):
        depths = [b.depth() for b in self.batchers]
        lo = min(depths)
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % self.replicas
        for k in range(self.replicas):
            i = (start + k) % self.replicas
            if depths[i] == lo:
                return i
        return 0                        # pragma: no cover - lo in depths

    def submit(self, *arrays, timeout_ms=None, priority="interactive"):
        """Route one request to the least-loaded replica; returns
        (future, replica_index)."""
        i = self._least_loaded()
        fut = self.batchers[i].submit(*arrays, timeout_ms=timeout_ms,
                                      priority=priority)
        return fut, i

    def infer(self, *arrays, timeout_ms=None, priority="interactive"):
        fut, _ = self.submit(*arrays, timeout_ms=timeout_ms,
                             priority=priority)
        return fut.result()

    # -- accounting ----------------------------------------------------------

    def depth(self):
        return sum(b.depth() for b in self.batchers)

    def resident_bytes(self):
        """Summed plan-cache footprint across replicas — the model's
        LRU eviction cost in the ModelRouter."""
        return sum(int(getattr(e, "plan_resident_bytes", 0) or 0)
                   for e in self.engines)

    def plan_compiles(self):
        return sum(len(getattr(e, "plan_bytes", {}) or {})
                   for e in self.engines)

    def warmup(self):
        for e in self.engines:
            w = getattr(e, "warmup", None)
            if w:
                w()
        for b in self.batchers:
            b._sync_plan_bytes()

    def stats(self):
        per = [b.metrics.snapshot() for b in self.batchers]
        return {
            "model": self.model_name,
            "replicas": self.replicas,
            "depth": self.depth(),
            "resident_bytes": self.resident_bytes(),
            "plans": self.plan_compiles(),
            "requests": sum(s["requests"] for s in per),
            "completed": sum(s["completed"] for s in per),
            "shed": sum(s["shed"] for s in per),
            "timeouts": sum(s["timeouts"] for s in per),
            "per_replica": per,
        }

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain=True):
        """Idempotent: joins every batcher worker, unregisters the
        per-replica metrics hooks, closes engines that support it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for b in self.batchers:
            b.close(drain=drain)
            b.metrics.close()
        for e in self.engines:
            close = getattr(e, "close", None)
            if close:
                close()

    __enter__ = lambda self: self

    def __exit__(self, *exc):
        self.close()
        return False
