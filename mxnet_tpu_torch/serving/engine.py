"""ServingEngine — a batch-size ladder over an exported ``.mxa``
(counterpart of mxnet_tpu/serving/engine.py).

The artifact binds ONE batch shape at export time (the MXPredCreate
contract, contrib/export.py); under serving load the request batch is
whatever the micro-batcher coalesced. The JAX package compiles one XLA
plan per power-of-two bucket, each padding to the export batch on the
device. The port's program is traced at the export batch, so every
bucket's plan would run the same export-batch program (equal device time
at every bucket): the engine keeps ONE plan at the export batch. A
request of n rows fills rows [0, n) of the plan's input buffers, the
device zeroes the rest, the program runs and its outputs are sliced back
to n. The bucket ladder (the manifest's ``serving`` block, else derived)
stays for ``bucket_for`` and ``stats()``, as in the JAX package.

On the card the plan is a CUDA graph over static input buffers, captured
(after a warm-up call outside the graph) on the engine's own stream into
the engine's memory pool. A call copies the host rows into pinned
buffers, copies them to the card on that stream, zeroes the padding rows,
replays the graph, copies the outputs to pinned memory and synchronises
the stream. Replays raise the launch counters by what the capture moved
them (``ops/launches.py``; the exported program launches no hand-written
kernel, so by nothing today). The plan's sizes come from its capture:
``plan_peak_bytes`` is the capture's peak (``devstats.capture_mark`` /
``capture_peak``), ``plan_bytes`` what it added to the pool,
``plan_resident_bytes`` their sum; ``devstats.preflight`` refuses the plan
whose peak does not fit before it enters the cache. A capture or replay
that fails raises: nothing falls back to an eager call. On the CPU the
plan calls the program eagerly; its ``plan_bytes`` is its input and
output bytes (what the JAX package's engine charges a plan on a backend
that reports no code size).

Thread-safe: plan creation and execution are serialised by the engine's
lock, so one engine has one batch in flight; an EnginePool runs R engines
(each its own stream and graph) for R in flight.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops.launches import add as _add_launches, counts as _launch_counts
from ..predictor import Predictor, f32_scope
from ..telemetry import devstats
from ..telemetry import tracing as _tracing
from ..contrib.export import serving_buckets as _pow2_buckets


class _Plan:
    """The engine's plan: ``fn(static inputs) -> outputs`` over static
    float32 input buffers of the export batch on the engine's device; a
    CUDA graph on the card."""

    def __init__(self, batch, shapes, fn, device):
        cuda = device.type == "cuda"
        self.batch = batch
        self.fn = fn
        self.device = device
        self.static_in = [torch.zeros((batch,) + s, dtype=torch.float32,
                                      device=device) for s in shapes]
        # host staging: pinned buffers on the card; on the host the static
        # buffers themselves
        self.host_in = [torch.zeros((batch,) + s, dtype=torch.float32,
                                    pin_memory=True) for s in shapes] \
            if cuda else self.static_in
        self.host_out = None
        self.out = None
        self.graph = None
        self.launches = {}
        self.peak_bytes = 0
        self.capture_s = 0.0

    def capture(self, stream, pool):
        """A warm-up call on ``stream`` outside any graph (cuDNN's and
        cuBLAS's handles and workspaces for the stream), then the capture
        into ``pool``, all in full float32."""
        dev = self.device
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with f32_scope(), torch.cuda.stream(stream):
            self.fn(self.static_in)
            stream.synchronize()
            before = _launch_counts()
            mark = devstats.capture_mark(pool, dev)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.out = self.fn(self.static_in)
            finally:
                graph.capture_end()
        after = _launch_counts()
        self.launches = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        self.peak_bytes = devstats.capture_peak(pool, dev, mark)
        self.graph = graph
        self.host_out = [torch.empty(o.shape, dtype=o.dtype,
                                     pin_memory=True) for o in self.out]
        self.capture_s = time.perf_counter() - t0

    def run(self, arrays, n, stream):
        """The plan on host ``arrays`` of n rows each: rows [n, batch)
        of the inputs are zeros; a list of numpy outputs of the whole
        export batch (copies)."""
        for h, a in zip(self.host_in, arrays):
            h.numpy()[:n] = a
        if self.graph is None:
            for h in self.host_in:
                h[n:].zero_()
            return [o.numpy().copy() for o in self.fn(self.static_in)]
        with torch.cuda.stream(stream):
            for s, h in zip(self.static_in, self.host_in):
                s[:n].copy_(h[:n], non_blocking=True)
                if n < self.batch:
                    s[n:].zero_()
            self.graph.replay()
            for h, o in zip(self.host_out, self.out):
                h.copy_(o, non_blocking=True)
        stream.synchronize()
        _add_launches(self.launches)
        return [h.numpy().copy() for h in self.host_out]

    def release(self):
        self.graph = self.out = self.host_out = None


class ServingEngine:
    """Load a ``.mxa`` artifact (or wrap a Predictor) and serve any
    request batch <= the export batch through one plan at the export
    batch, on the card unless ``device="cpu"``."""

    def __init__(self, model, device=None, buckets=None, warmup=True):
        self._pred = model if isinstance(model, Predictor) \
            else Predictor(model, device=device)
        man = self._pred.manifest
        serving = man.get("serving", {})
        # compute dtype baked into the program; request and response I/O
        # are float32 either way (the casts are inside the program)
        self.amp_dtype = serving.get("amp_dtype") \
            or man.get("dtype", "float32")
        self.batch_axis = int(serving.get("batch_axis", 0))
        if self.batch_axis != 0:
            raise ValueError("ServingEngine: only batch_axis 0 artifacts "
                             "are supported")
        self.max_batch = self._pred.export_batch
        ladder = buckets or serving.get("buckets") \
            or _pow2_buckets(self.max_batch)
        ladder = sorted({int(b) for b in ladder if 1 <= int(b)})
        if any(b > self.max_batch for b in ladder):
            raise ValueError(f"ServingEngine: bucket larger than the "
                             f"export batch {self.max_batch}")
        if not ladder or ladder[-1] != self.max_batch:
            ladder.append(self.max_batch)
        self.buckets = ladder
        self.input_names = list(self._pred._input_names)
        self.output_names = list(self._pred.output_names)
        self.model_name = str(man.get("model_name")
                              or serving.get("model") or "model")
        self.device = self._pred._dev
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._plans = {}                # {export batch: the plan}
        self.plan_bytes = {}            # export batch -> bytes it holds
        self.plan_peak_bytes = {}       # export batch -> its capture's peak
        self.plan_resident_bytes = 0    # sum over cached plans
        self._lock = threading.RLock()
        self.plan_compiles = 0          # plans built (cache misses)
        self.executions = 0             # plan runs
        self.padded_rows = 0            # rows padded up to the export batch
        if warmup:
            self.warmup()

    @classmethod
    def from_symbol(cls, symbol, arg_params, aux_params, data_shapes,
                    path=None, **kwargs):
        """Export ``symbol`` through contrib.export and serve the artifact
        (the one-call train -> serve bridge)."""
        import os
        import tempfile
        from ..contrib.export import export_model
        if path is None:
            path = os.path.join(tempfile.mkdtemp(prefix="mxa_serve_"),
                                "model.mxa")
        export_model(path, symbol, arg_params, aux_params, data_shapes)
        return cls(path, **kwargs)

    # -- plan cache ---------------------------------------------------------

    def bucket_for(self, n):
        """Smallest bucket >= n (the ladder's step of an n-row batch;
        every batch runs the one export-batch plan)."""
        if n < 1 or n > self.max_batch:
            raise ValueError(f"batch {n} outside [1, {self.max_batch}]")
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _plan(self):
        batch = self.max_batch
        plan = self._plans.get(batch)
        if plan is not None:
            return plan
        shapes = [tuple(self._pred._input_shapes[n][1:])
                  for n in self.input_names]
        plan = _Plan(batch, shapes, lambda xs: self._pred._run(*xs),
                     self.device)
        name = "%s.serving.b%d" % (self.model_name, batch)
        if self._stream is not None:
            held = devstats.pool_bytes(self._pool, self.device)
            plan.capture(self._stream, self._pool)
            resident = devstats.pool_bytes(self._pool, self.device) - held
        else:
            io_bytes = sum(4 * batch * int(np.prod(s)) for s in shapes)
            io_bytes += sum(4 * batch * int(np.prod(s[1:]))
                            for _, s in self._pred.output_shapes)
            resident = plan.peak_bytes = io_bytes
        if devstats.enabled():
            devstats.record_program(name, {"peak_bytes": plan.peak_bytes,
                                           "resident_bytes": resident},
                                    kind="serving")
            try:
                # refuse the plan BEFORE admitting it to the cache
                devstats.preflight(name, plan.peak_bytes,
                                   resident_bytes=self.plan_resident_bytes,
                                   what="serving plan",
                                   device=self.device)
            except devstats.HBMPreflightError:
                plan.release()
                raise
            devstats.note_compile(name)
        self._plans[batch] = plan
        self.plan_bytes[batch] = int(resident)
        self.plan_peak_bytes[batch] = int(plan.peak_bytes)
        self.plan_resident_bytes = sum(self.plan_bytes.values())
        self.plan_compiles += 1
        return plan

    def warmup(self):
        """Build the plan up front, so no request pays a capture. Its
        dummy inputs are made on the device feed's thread (``pipeline``),
        as the JAX package's warm-up makes each bucket's."""
        from ..pipeline import close_feed, feed_or_inline

        def _stage(b):
            return [np.zeros((b,) + tuple(self._pred._input_shapes[n][1:]),
                             np.float32) for n in self.input_names]

        feed = feed_or_inline(iter([1]), _stage, name="serving_warmup")
        try:
            with self._lock:
                for staged in feed:
                    self._run(staged)
        finally:
            close_feed(feed)

    # -- request path -------------------------------------------------------

    def _run(self, arrays):
        n = int(arrays[0].shape[0])
        outs = self._plan().run(arrays, n, self._stream)
        self.executions += 1
        self.padded_rows += self.max_batch - n
        return self._rows(outs, n)

    def _rows(self, outs, n):
        """The request's rows of the plan's outputs."""
        return [o[:n] if o.ndim and o.shape[0] == self.max_batch else o
                for o in outs]

    def infer(self, *arrays):
        """Run one already-coalesced batch (n rows, 1 <= n <= max_batch,
        batch axis 0). Returns a list of numpy arrays sliced to n."""
        arrays = [np.asarray(getattr(a, "asnumpy", lambda: a)(), np.float32)
                  for a in arrays]
        if len(arrays) != len(self.input_names):
            raise ValueError(f"expected {len(self.input_names)} inputs "
                             f"{self.input_names}, got {len(arrays)}")
        n = int(arrays[0].shape[0])
        for name, a in zip(self.input_names, arrays):
            want = self._pred._input_shapes[name]
            if a.shape[0] != n or tuple(a.shape[1:]) != tuple(want[1:]):
                raise ValueError(
                    f"input {name!r}: shape {tuple(a.shape)} is not "
                    f"(n<= {self.max_batch},)+{tuple(want[1:])}")
        self.bucket_for(n)                  # raises outside [1, max_batch]
        # "serve" span: the lock wait and the plan's run, the compute
        # latency a request sees
        with _tracing.span("serve.compute", phase="serve",
                           bucket=self.max_batch, rows=n):
            with self._lock:
                return self._run(arrays)

    def stats(self):
        return {"buckets": list(self.buckets),
                "max_batch": self.max_batch,
                "amp_dtype": self.amp_dtype,
                "model": self.model_name,
                "plan_compiles": self.plan_compiles,
                "plans": len(self._plans),
                "plan_bytes": dict(self.plan_bytes),
                "plan_peak_bytes": dict(self.plan_peak_bytes),
                "plan_resident_bytes": self.plan_resident_bytes,
                "executions": self.executions,
                "padded_rows": self.padded_rows}

    def close(self):
        """Drop the plan (its graph and pool memory with it)."""
        with self._lock:
            for p in self._plans.values():
                p.release()
            self._plans.clear()
