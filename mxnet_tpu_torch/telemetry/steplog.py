"""Step-level training telemetry (counterpart of
mxnet_tpu/telemetry/steplog.py).

A ``StepLogger`` rides the training loops (``BaseModule.fit`` per batch,
``Module._fit_fused``, Gluon ``fused_fit``) and records, per step (or per
fused block of K steps): wall time, samples/s, the loss when the loop
already has it on the host, the amp loss scale and skipped steps, the
DeviceFeed overlap fraction, and the checkpoint save / wait time accrued
since the last step; with ``MXNET_TRACE=1`` also the feed / compute /
comm / ckpt breakdown of the step from the spans.

Two sinks:
  - the registry (``mxnet_step_time_seconds`` histogram,
    ``mxnet_steps_total`` / ``mxnet_samples_total`` counters,
    ``mxnet_step_loss`` / ``mxnet_samples_per_second`` gauges), live at
    ``/metrics``;
  - a JSONL event log when ``MXNET_TELEMETRY_LOG=<path>`` is set
    (``run_start`` / ``step`` / ``run_end`` records, one JSON object a
    line, flushed a write).

Nothing here reads the card: the loss is recorded only when the loop
passes a host float it already has, the amp counters are sampled only
while amp is on, and the feed and checkpoint counters are host dicts.
Every ``step()`` beats the stall watchdog. ``MXNET_TELEMETRY=0`` swaps in
``_NullStepLogger``, which still beats the watchdog and records nothing.
Each step's ``mfu`` / ``roofline_frac`` / ``model_flops_per_s`` come from
``devstats.step_sample`` (the step program's FLOPs and bytes, counted by
``telemetry.costs``, published by the fused fits' trainers); the run_end
record of a fused fit carries ``devstats.fit_summary()``.
"""
from __future__ import annotations

import json
import os
import threading
import time

from . import watchdog as _watchdog
from .registry import counter, gauge, histogram

__all__ = ["StepLogger", "maybe_step_logger", "enabled", "log_event"]

# step durations: 100us host-bound micro-steps through multi-minute
# stalls (the watchdog owns anything beyond)
STEP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                60.0, 120.0)


def enabled():
    """MXNET_TELEMETRY master gate (default on)."""
    from .. import config
    return bool(config.get("MXNET_TELEMETRY", 1))


def _log_path():
    from .. import config
    return config.get("MXNET_TELEMETRY_LOG") or None


class _NullStepLogger:
    """Telemetry-off stand-in: same surface, records nothing, still
    beats the watchdog (hang diagnostics stay armed without metrics)."""

    def step(self, samples=None, loss=None, steps=1, extra=None):
        _watchdog.beat()

    def close(self, **extra):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class StepLogger:
    """Per-loop telemetry recorder. One instance per fit call.

    step(samples=, loss=, steps=K): record one dispatch — K fused steps
    ran in it (K=1 on per-batch paths), `samples` rows were consumed,
    `loss` is an optional host-side float the loop already had. Wall
    time is measured here (time since the previous step()/construction),
    so the loop adds exactly one call per dispatch.
    """

    def __init__(self, phase, meta=None, registry_prefix="mxnet"):
        self.phase = str(phase)
        self._lock = threading.Lock()
        self._t_last = time.perf_counter()
        self._t0 = self._t_last
        self._n = 0
        self._samples = 0
        self._file = None
        p = registry_prefix
        self._h_step = histogram(
            f"{p}_step_time_seconds",
            help="per-training-step wall time (fused blocks record "
                 "block_time/K per step)", buckets=STEP_BUCKETS)
        self._c_steps = counter(f"{p}_steps_total",
                                help="training steps completed")
        self._c_samples = counter(f"{p}_samples_total",
                                  help="training samples consumed")
        self._g_loss = gauge(f"{p}_step_loss",
                             help="last host-reported training loss")
        self._g_rate = gauge(f"{p}_samples_per_second",
                             help="instantaneous training throughput")
        # subsystem counter baselines for per-step deltas
        self._ckpt_last = self._ckpt_counters()
        self._zero_last = self._zero_counters()
        self._embed_last = self._embed_counters()
        # run-scoped trace id: spans closing during this run carry it
        # (tracing.set_step), so JSONL rows and timeline spans correlate
        self.trace_id = "%012x" % int.from_bytes(os.urandom(6), "big")
        self._trace_last = None
        from . import tracing as _tracing
        self._tracing = _tracing
        _tracing.set_step(self.trace_id, 0)
        path = _log_path()
        if path:
            try:
                self._file = open(path, "a", encoding="utf-8")
            except OSError:
                self._file = None
        self._emit({"event": "run_start", "phase": self.phase,
                    "pid": os.getpid(), "trace_id": self.trace_id,
                    **(meta or {})})

    # -- subsystem sampling (host dicts only) -------------------------------

    @staticmethod
    def _ckpt_counters():
        from .. import profiler
        c = profiler.export_counter("checkpoint")
        if not isinstance(c, dict):
            return {"ckpt_save_us": 0, "ckpt_wait_us": 0}
        return {"ckpt_save_us": int(c.get("ckpt_save_us", 0)),
                "ckpt_wait_us": int(c.get("ckpt_wait_us", 0))}

    @staticmethod
    def _zero_counters():
        """ZeRO wire / overlap counters (a "zero" counter export; None
        while none is registered keeps the JSONL free of zero_* keys)."""
        from .. import profiler
        c = profiler.export_counter("zero")
        if not isinstance(c, dict):
            return None
        return {"zero_wire_bytes": int(c.get("zero_wire_bytes", 0)),
                "zero_overlap_frac": c.get("zero_overlap_frac")}

    @staticmethod
    def _embed_counters():
        """Sharded-embedding exchange counters (parallel.embedding
        registers its hook once an EmbeddingTrainer exists; None until
        then keeps the JSONL free of dead embed_* keys). Scraping reads
        the trainer's deferred nnz scalar from the card: at log cadence,
        never on the step path."""
        from .. import profiler
        c = profiler.export_counter("embed")
        if not isinstance(c, dict):
            return None
        return {"embed_wire_bytes": int(c.get("embed_wire_bytes", 0)),
                "embed_touched_frac": c.get("embed_touched_frac")}

    @staticmethod
    def _amp_sample():
        from .. import amp
        if not amp.is_enabled():
            return None, 0
        try:
            c = amp.counters()
            return c.get("amp_scale"), int(c.get("amp_skipped_steps", 0))
        except Exception:               # pragma: no cover
            return None, 0

    @staticmethod
    def _feed_overlap():
        from .. import pipeline
        try:
            return pipeline.stats().get("overlap_frac")
        except Exception:               # pragma: no cover
            return None

    def _trace_sample(self, wall, n):
        """Per-step phase breakdown from tracing's phase accumulators:
        feed_us is consumer time BLOCKED on the feed ("feed" spans —
        feeder-side staging records under "feed_stage" and does not
        count), comm_us is time blocked in dist waits, so
        1 - blocked/wall is a measured overlap fraction. Returns the
        JSONL fields (None when MXNET_TRACE=0) and sets the overlap
        gauges for /metrics."""
        tr = self._tracing
        tr.set_step(self.trace_id, n)
        if not tr.enabled():
            return None
        totals = tr.phase_totals()
        # the baseline swap rides self._lock: step() is normally a
        # single-caller path, but watchdog/exporter threads may drive a
        # sample concurrently and a torn read-then-write here would
        # double-count a phase delta
        with self._lock:
            last = self._trace_last or {}
            self._trace_last = totals

        def delta(k):
            return max(0, int(totals.get(k, 0) - last.get(k, 0)))

        out = {"feed_us": delta("feed"), "compute_us": delta("compute"),
               "comm_us": delta("comm"), "ckpt_us": delta("ckpt")}
        wall_us = wall * 1e6
        if wall_us > 0:
            feed_ov = max(0.0, min(1.0, 1.0 - out["feed_us"] / wall_us))
            comm_ov = max(0.0, min(1.0, 1.0 - out["comm_us"] / wall_us))
            out["feed_compute_overlap_frac"] = round(feed_ov, 4)
            out["comm_compute_overlap_frac"] = round(comm_ov, 4)
            gauge("mxnet_trace_feed_compute_overlap_frac",
                  help="1 - feed-blocked/wall over the last step "
                       "window").set(out["feed_compute_overlap_frac"])
            gauge("mxnet_trace_comm_compute_overlap_frac",
                  help="1 - comm-blocked/wall over the last step "
                       "window").set(out["comm_compute_overlap_frac"])
        return out

    # -- recording ----------------------------------------------------------

    def step(self, samples=None, loss=None, steps=1, extra=None):
        now = time.perf_counter()
        _watchdog.beat(f"{self.phase} step")
        with self._lock:
            wall = now - self._t_last
            self._t_last = now
            self._n += int(steps)
            n = self._n
            if samples:
                self._samples += int(samples)
        per_step = wall / max(int(steps), 1)
        self._h_step.observe(per_step)
        self._c_steps.inc(int(steps))
        if samples:
            self._c_samples.inc(int(samples))
            if wall > 0:
                self._g_rate.set(round(samples / wall, 3))
        if loss is not None:
            self._g_loss.set(float(loss))
        trace_fields = self._trace_sample(wall, n)
        # MFU and roofline attainment from the step program's counted
        # FLOPs and bytes (host floats; gauges set even without a sink)
        try:
            from . import devstats as _devstats
            devstats_fields = _devstats.step_sample(wall, int(steps))
        except Exception:
            devstats_fields = None
        if self._file is None:
            return
        amp_scale, amp_skipped = self._amp_sample()
        ckpt = self._ckpt_counters()
        rec = {"event": "step", "phase": self.phase, "step": n,
               "wall_s": round(wall, 6), "steps": int(steps),
               "samples": int(samples) if samples else None,
               "samples_per_s": round(samples / wall, 3)
               if samples and wall > 0 else None,
               "loss": float(loss) if loss is not None else None,
               "amp_scale": amp_scale, "amp_skipped_steps": amp_skipped,
               "feed_overlap_frac": self._feed_overlap(),
               "ckpt_save_us": ckpt["ckpt_save_us"]
               - self._ckpt_last["ckpt_save_us"],
               "ckpt_wait_us": ckpt["ckpt_wait_us"]
               - self._ckpt_last["ckpt_wait_us"]}
        if trace_fields:
            rec["trace_id"] = self.trace_id
            rec.update(trace_fields)
        if devstats_fields:
            rec.update(devstats_fields)
        zero = self._zero_counters()
        if zero is not None:
            last = self._zero_last or {"zero_wire_bytes": 0}
            rec["zero_wire_bytes"] = zero["zero_wire_bytes"] \
                - last.get("zero_wire_bytes", 0)
            rec["zero_overlap_frac"] = zero["zero_overlap_frac"]
        embed = self._embed_counters()
        if embed is not None:
            elast = self._embed_last or {"embed_wire_bytes": 0}
            rec["embed_wire_bytes"] = embed["embed_wire_bytes"] \
                - elast.get("embed_wire_bytes", 0)
            rec["embed_touched_frac"] = embed["embed_touched_frac"]
        with self._lock:
            self._ckpt_last = ckpt
            self._zero_last = zero
            self._embed_last = embed
        if extra:
            rec.update(extra)
        self._emit(rec)

    def close(self, **extra):
        wall = time.perf_counter() - self._t0
        self._emit({"event": "run_end", "phase": self.phase,
                    "steps": self._n, "samples": self._samples,
                    "wall_s": round(wall, 6),
                    "samples_per_s": round(self._samples / wall, 3)
                    if wall > 0 and self._samples else None, **extra})
        f = self._file
        if f is not None:
            try:
                f.close()
            finally:
                with self._lock:
                    self._file = None

    def _emit(self, rec):
        f = self._file
        if f is None:
            return
        rec.setdefault("ts", round(time.time(), 3))
        try:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        except (OSError, ValueError):   # disk full / closed file
            with self._lock:
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def log_event(event, **fields):
    """Append one structured JSONL record OUTSIDE any StepLogger run —
    rare out-of-band events. Same MXNET_TELEMETRY_LOG sink as the step
    records; open/append/close per event, so it is safe from any thread
    at any time and costs nothing when no log is configured. Returns
    True when a record was written."""
    path = _log_path()
    if not path:
        return False
    rec = {"event": str(event), "ts": round(time.time(), 3),
           "pid": os.getpid()}
    rec.update(fields)
    try:
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        return True
    except (OSError, ValueError, TypeError):
        return False


def maybe_step_logger(phase, meta=None):
    """The training loops' entry point: a real StepLogger when telemetry
    is on, the null recorder (watchdog beats only) when MXNET_TELEMETRY=0.
    Never raises — a broken telemetry config must not take down fit."""
    try:
        if enabled():
            return StepLogger(phase, meta=meta)
    except Exception:                   # pragma: no cover
        pass
    return _NullStepLogger()
