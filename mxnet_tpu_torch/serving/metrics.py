"""Serving counters — QPS, latency percentiles, batch histogram, queue
depth, shed/timeout counts (counterpart of mxnet_tpu/serving/metrics.py).

``snapshot()`` / ``to_json()`` give the numbers to the serving CLI and
tools. Queue depth, request latency, the engine's plan-cache bytes
(``record_plan_bytes``) and the per-admission-class shed and timeout
totals are native series of the telemetry registry, so ``/metrics``
carries them as ``mxnet_serving_*`` with ``model`` (the manifest's
model name), ``replica`` (in an EnginePool) and ``class`` labels. The
whole snapshot is also the profiler's counter export under the metrics'
name, which the registry absorbs into ``/metrics`` and ``profiler.dump()``
embeds; ``close()`` unhooks it.

Latency percentiles come from a bounded reservoir of the most recent
``latency_window`` request latencies (a deque ring): O(1) record, exact
percentiles over the window.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

from ..telemetry import counter, gauge, histogram

__all__ = ["ServingMetrics"]


class ServingMetrics:
    """Thread-safe serving counters; one instance per batcher/engine."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, name="serving", latency_window=4096, model=None,
                 replica=None):
        with ServingMetrics._seq_lock:
            ServingMetrics._seq += 1
            seq = ServingMetrics._seq
        self.name = name if seq == 1 else f"{name}#{seq}"
        self.model = str(model) if model else None
        self.replica = None if replica is None else int(replica)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests = 0          # accepted submits
        self.completed = 0         # futures resolved with a result
        self.shed = 0              # rejected at submit (queue full)
        self.timeouts = 0          # expired before execution
        self.shed_by_class = {}    # admission class -> shed count
        self.timeouts_by_class = {}
        self.errors = 0            # engine raised; future got the error
        self.batches = 0           # compiled-plan invocations
        self.batched_rows = 0      # rows across all batches
        self.queue_depth = 0       # live queue size (gauge)
        self.plan_resident_bytes = 0   # engine plan-cache footprint
        self.plans = 0                 # cached engine plans
        self._batch_hist = {}      # rows -> count
        self._lat = deque(maxlen=latency_window)
        from .. import profiler
        dom = profiler.Domain(self.name)
        self._c_depth = dom.new_counter("queue_depth")
        self._c_shed = dom.new_counter("shed_total")
        profiler.register_counter_export(self.name, self.snapshot)
        # native registry series ("#2" -> "_2" for metric-name legality);
        # model name from the .mxa manifest rides as a constant label so
        # a multi-model process gets distinguishable series without the
        # model leaking into metric names
        self._counter = counter
        mname = self.name.replace("#", "_")
        labels = {}
        if self.model:
            labels["model"] = self.model
        if self.replica is not None:
            labels["replica"] = str(self.replica)
        labels = labels or None
        self._mname = mname
        self._base_labels = dict(labels or {})
        self._g_depth = gauge(
            f"mxnet_{mname}_queue_depth",
            help="live dynamic-batcher queue size", labels=labels)
        self._h_lat = histogram(
            f"mxnet_{mname}_request_latency_seconds",
            help="submit-to-resolve request latency", labels=labels)
        self._g_plan_bytes = gauge(
            f"mxnet_{mname}_plan_resident_bytes",
            help="bytes resident in the engine's plan cache "
                 "(devstats accounting)", labels=labels)
        # per-class shed/timeout counters created lazily on first record,
        # one `series=` per admission class under a shared metric name —
        # the model/replica/class labels ride on EVERY shed or timeout,
        # including requests shed at submit before an engine is bound
        self._c_shed_cls = {}
        self._c_timeout_cls = {}

    def _class_counter(self, table, what, klass):
        """Get-or-create the per-class counter. Caller holds self._lock
        (the registry's own get-or-create makes a race merely wasteful,
        but the table write must be guarded like every other field)."""
        c = table.get(klass)
        if c is None:
            labels = dict(self._base_labels)
            labels["class"] = klass
            c = self._counter(
                f"mxnet_{self._mname}_{what}_total",
                help=f"requests {what} per admission class",
                labels=labels, series=klass)
            table[klass] = c
        return c

    def close(self):
        """Unhook the profiler export (the registry's series stay)."""
        from .. import profiler
        profiler.unregister_counter_export(self.name)

    # -- recording ----------------------------------------------------------

    def record_submit(self):
        with self._lock:
            self.requests += 1

    def record_shed(self, klass="interactive"):
        with self._lock:
            self.shed += 1
            self.shed_by_class[klass] = self.shed_by_class.get(klass, 0) + 1
            c = self._class_counter(self._c_shed_cls, "shed", klass)
        c.inc()
        self._c_shed.increment()

    def record_timeout(self, klass="interactive"):
        with self._lock:
            self.timeouts += 1
            self.timeouts_by_class[klass] = \
                self.timeouts_by_class.get(klass, 0) + 1
            c = self._class_counter(self._c_timeout_cls, "timeout", klass)
        c.inc()

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth
        self._g_depth.set(depth)
        from .. import profiler
        if profiler.is_running():
            self._c_depth.set_value(depth)

    def record_batch(self, rows):
        with self._lock:
            self.batches += 1
            self.batched_rows += rows
            self._batch_hist[rows] = self._batch_hist.get(rows, 0) + 1

    def record_done(self, latency_s):
        with self._lock:
            self.completed += 1
            self._lat.append(latency_s)
        self._h_lat.observe(latency_s)

    def record_plan_bytes(self, resident_bytes, plans=None):
        """Engine plan-cache footprint (ServingEngine.plan_resident_bytes,
        devstats-measured). Called after each plan admit and on batcher
        attach, so /metrics carries the live cache size next to QPS/p99."""
        with self._lock:
            self.plan_resident_bytes = int(resident_bytes)
            if plans is not None:
                self.plans = int(plans)
        self._g_plan_bytes.set(int(resident_bytes))

    # -- reading ------------------------------------------------------------

    def _percentile_ms(self, lat_sorted, p):
        if not lat_sorted:
            return None
        i = min(len(lat_sorted) - 1,
                int(round(p / 100.0 * (len(lat_sorted) - 1))))
        return round(lat_sorted[i] * 1e3, 3)

    def snapshot(self):
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            lat = sorted(self._lat)
            return {
                "requests": self.requests,
                "completed": self.completed,
                "shed": self.shed,
                "timeouts": self.timeouts,
                "shed_by_class": dict(self.shed_by_class),
                "timeouts_by_class": dict(self.timeouts_by_class),
                "errors": self.errors,
                "batches": self.batches,
                "batched_rows": self.batched_rows,
                "avg_batch_rows": round(self.batched_rows
                                        / self.batches, 3)
                if self.batches else None,
                "batch_hist": {str(k): v for k, v in
                               sorted(self._batch_hist.items())},
                "queue_depth": self.queue_depth,
                "qps": round(self.completed / elapsed, 2),
                "p50_ms": self._percentile_ms(lat, 50),
                "p99_ms": self._percentile_ms(lat, 99),
                "uptime_s": round(elapsed, 3),
                "model": self.model,
                "plans": self.plans,
                "plan_resident_bytes": self.plan_resident_bytes,
            }

    def to_json(self):
        return json.dumps(self.snapshot())
