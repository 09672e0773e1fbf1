"""DynamicBatcher — micro-batching request queue in front of a
ServingEngine (counterpart of mxnet_tpu/serving/batcher.py, the same
semantics and deadlines; each request's time in the queue is a
retrospective ``serve.queue`` span). ``Future`` and ``RequestTimeout``
are shared with the decode engine.

Clipper-style adaptive batching: concurrent callers `submit()` small
request batches (usually 1 row); a single worker thread coalesces
whatever is queued — up to `max_batch` rows, waiting at most
`max_wait_us` after the first request of a batch for stragglers — and
runs ONE compiled-plan execution for the whole coalesced batch. Under
load the wait never happens (the queue is already deep when the worker
comes back from the device), so throughput rides the biggest bucket
while lightly-loaded latency stays within `max_wait_us` of raw engine
latency.

Overload protocol (the load-shedding / backpressure contract):
  - the queue is bounded at `queue_depth` requests: `submit()` on a full
    queue raises `ServingQueueFull` immediately (shed at the door — the
    caller can retry/back off; nothing is silently dropped once
    accepted);
  - every request carries a deadline (`timeout_ms`, default
    `default_timeout_ms`); a request whose deadline passed while queued
    fails with `RequestTimeout` when the worker reaches it, and never
    occupies device time. `Future.result()` applies the same deadline
    client-side as a backstop.

Admission classes: every request belongs to `interactive` (default) or
`batch`. The two classes queue separately — the worker always drains
interactive first, and the batch queue is bounded at the smaller
`batch_queue_depth` quota — so under overload the batch class sheds and
times out FIRST while interactive latency stays near the engine floor.
Shed/timeout metrics carry the class.

All outcomes (completed / shed / timeout / error), per-request latency,
batch-size histogram and live queue depth are recorded in a
`ServingMetrics` (metrics.py), reachable as `batcher.metrics`.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..telemetry import tracing as _tracing
from .metrics import ServingMetrics

__all__ = ["ADMISSION_CLASSES", "DynamicBatcher", "Future", "RequestTimeout",
           "ServingQueueFull"]


class ServingQueueFull(RuntimeError):
    """submit() on a full queue — shed; back off and retry."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired before its result was ready."""


class Future:
    """Minimal completion handle (threading.Event based)."""

    __slots__ = ("_ev", "_value", "_exc", "_deadline")

    def __init__(self, deadline):
        self._ev = threading.Event()
        self._value = None
        self._exc = None
        self._deadline = deadline

    def _set(self, value):
        self._value = value
        self._ev.set()

    def _set_exception(self, exc):
        self._exc = exc
        self._ev.set()

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        if timeout is None and self._deadline is not None:
            # backstop: never block past the request's own deadline
            timeout = max(self._deadline - time.monotonic(), 0.0) + 1.0
        if not self._ev.wait(timeout):
            raise RequestTimeout("result() timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


ADMISSION_CLASSES = ("interactive", "batch")


class _Request:
    __slots__ = ("arrays", "rows", "t_submit", "t_perf", "deadline",
                 "future", "klass")

    def __init__(self, arrays, rows, deadline, klass="interactive"):
        self.arrays = arrays
        self.rows = rows
        self.t_submit = time.monotonic()
        self.t_perf = time.perf_counter()     # the tracing clock
        self.deadline = deadline
        self.future = Future(deadline)
        self.klass = klass


class DynamicBatcher:
    """Coalesce concurrent requests into bucketed engine executions.

    Parameters
    ----------
    engine : object with `max_batch`, `input_names` and
        `infer(*arrays) -> [np.ndarray]` (normally a ServingEngine).
    max_batch : rows per coalesced execution; defaults to (and may not
        exceed) `engine.max_batch`.
    max_wait_us : how long the worker lingers for stragglers after the
        first request of a batch. 0 = never wait (pure greedy drain).
    queue_depth : bound on QUEUED interactive requests; submit() past
        it sheds.
    batch_queue_depth : bound on QUEUED batch-class requests; defaults
        to `max(1, queue_depth // 2)` so batch sheds first.
    default_timeout_ms : per-request deadline when submit() gives none;
        None = no deadline.
    """

    def __init__(self, engine, max_batch=None, max_wait_us=2000,
                 queue_depth=64, batch_queue_depth=None,
                 default_timeout_ms=None, metrics=None):
        self.engine = engine
        cap = int(getattr(engine, "max_batch", 0) or 0)
        self.max_batch = int(max_batch or cap or 1)
        if cap and self.max_batch > cap:
            raise ValueError(f"max_batch {self.max_batch} exceeds the "
                             f"engine's export batch {cap}")
        self.max_wait_s = max_wait_us / 1e6
        self.queue_depth = int(queue_depth)
        self.batch_queue_depth = int(batch_queue_depth
                                     if batch_queue_depth is not None
                                     else max(1, self.queue_depth // 2))
        self.default_timeout_ms = default_timeout_ms
        self.metrics = metrics or ServingMetrics(
            model=getattr(engine, "model_name", None))
        self._sync_plan_bytes()
        self._q = deque()           # interactive class (drained first)
        self._qb = deque()          # batch class
        self._inflight = 0          # requests taken but not yet resolved
        self._cond = threading.Condition()
        self._stopped = False
        self._worker = threading.Thread(target=self._loop,
                                        name="mxnet_tpu_torch-serving-batcher",
                                        daemon=True)
        self._worker.start()

    def _sync_plan_bytes(self):
        """Mirror the engine's plan-cache footprint (devstats-measured
        resident bytes per admitted plan) into the metrics, so the gauge
        tracks a lazy plan admit as infer() triggers it."""
        resident = getattr(self.engine, "plan_resident_bytes", None)
        if resident is not None:
            plans = getattr(self.engine, "plan_bytes", None)
            self.metrics.record_plan_bytes(
                resident, plans=len(plans) if plans is not None else None)

    # -- client side --------------------------------------------------------

    def submit(self, *arrays, timeout_ms=None, priority="interactive"):
        """Enqueue one request (rows <= max_batch, batch axis 0);
        returns a Future. Raises ServingQueueFull when the class's
        bounded queue is at capacity (batch-class quota is smaller, so
        overload sheds batch first)."""
        if self._stopped:
            raise RuntimeError("batcher is closed")
        klass = str(priority or "interactive")
        if klass not in ADMISSION_CLASSES:
            raise ValueError(f"priority {klass!r} not in "
                             f"{ADMISSION_CLASSES}")
        arrays = [np.asarray(getattr(a, "asnumpy", lambda: a)(), np.float32)
                  for a in arrays]
        rows = int(arrays[0].shape[0]) if arrays and arrays[0].ndim else 1
        if rows < 1 or rows > self.max_batch:
            raise ValueError(f"request rows {rows} outside "
                             f"[1, {self.max_batch}]")
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms is not None else None)
        req = _Request(arrays, rows, deadline, klass=klass)
        q = self._q if klass == "interactive" else self._qb
        cap = self.queue_depth if klass == "interactive" \
            else self.batch_queue_depth
        with self._cond:
            if len(q) >= cap:
                self.metrics.record_shed(klass)
                raise ServingQueueFull(
                    f"{klass} queue at capacity ({cap}); shedding")
            q.append(req)
            self.metrics.record_submit()
            self.metrics.record_queue_depth(len(self._q)
                                            + len(self._qb))
            self._cond.notify()
        return req.future

    def infer(self, *arrays, timeout_ms=None, priority="interactive"):
        """Blocking convenience wrapper: submit + result."""
        return self.submit(*arrays, timeout_ms=timeout_ms,
                           priority=priority).result()

    def depth(self):
        """Live load: queued (both classes) + taken-but-unresolved.
        The EnginePool's least-loaded dispatch keys off this."""
        with self._cond:
            return len(self._q) + len(self._qb) + self._inflight

    def close(self, drain=True):
        """Stop the worker. With drain=True pending requests are served
        first; otherwise they fail with RuntimeError."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            if not drain:
                for q in (self._q, self._qb):
                    while q:
                        req = q.popleft()
                        req.future._set_exception(
                            RuntimeError("batcher closed"))
            self._cond.notify_all()
        self._worker.join(timeout=30)

    __enter__ = lambda self: self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- worker side --------------------------------------------------------

    def _pop_expired(self, req, now):
        """True (and fail the future) when req's deadline passed."""
        if req.deadline is not None and now > req.deadline:
            self.metrics.record_timeout(req.klass)
            req.future._set_exception(RequestTimeout(
                f"deadline exceeded after "
                f"{(now - req.t_submit) * 1e3:.1f} ms in queue"))
            return True
        return False

    def _take_batch(self):
        """Block until work (or stop); return the coalesced request
        list, honoring max_batch rows and the max_wait_us linger.
        Interactive requests are always taken before batch-class ones;
        when the interactive head doesn't fit the remaining rows the
        scan stops rather than letting batch work jump the line."""
        with self._cond:
            while not (self._q or self._qb) and not self._stopped:
                self._cond.wait()
            if not (self._q or self._qb):
                return None                      # stopped and drained
            batch, rows = [], 0
            t_first = time.monotonic()
            linger_until = t_first + self.max_wait_s
            while True:
                now = time.monotonic()
                full = False
                for q in (self._q, self._qb):
                    while q and not full:
                        req = q[0]
                        if self._pop_expired(req, now):
                            q.popleft()
                            continue
                        if rows + req.rows > self.max_batch:
                            full = True
                            break
                        q.popleft()
                        batch.append(req)
                        rows += req.rows
                        if rows == self.max_batch:
                            full = True
                    if full:
                        break
                remaining = linger_until - now
                if rows >= self.max_batch or full or remaining <= 0 \
                        or self._stopped:
                    break
                if not batch and not self._q and not self._qb:
                    # everything seen so far expired; wait fresh
                    t_first = time.monotonic()
                    linger_until = t_first + self.max_wait_s
                    self._cond.wait()
                    if self._stopped and not self._q and not self._qb:
                        return None
                    continue
                self._cond.wait(timeout=remaining)
            self._inflight += len(batch)
            self.metrics.record_queue_depth(len(self._q)
                                            + len(self._qb))
            return batch

    def _run_batch(self, batch):
        arrays = [np.concatenate([r.arrays[i] for r in batch], axis=0)
                  for i in range(len(batch[0].arrays))] \
            if len(batch) > 1 else list(batch[0].arrays)
        rows = sum(r.rows for r in batch)
        # each request's time in the queue: a retrospective "serve" span
        # (the engine's serve.compute span follows inside infer())
        for r in batch:
            _tracing.event("serve.queue", r.t_perf, phase="serve",
                           rows=r.rows)
        try:
            outs = self.engine.infer(*arrays)
        except Exception as e:
            for r in batch:
                self.metrics.record_error()
                r.future._set_exception(e)
            return
        self.metrics.record_batch(rows)
        self._sync_plan_bytes()
        now = time.monotonic()
        off = 0
        for r in batch:
            sl = [o[off:off + r.rows]
                  if getattr(o, "ndim", 0) and o.shape[0] == rows
                  else o for o in outs]
            off += r.rows
            self.metrics.record_done(now - r.t_submit)
            r.future._set(sl)

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:
                continue
            try:
                self._run_batch(batch)
            finally:
                with self._cond:
                    self._inflight -= len(batch)
