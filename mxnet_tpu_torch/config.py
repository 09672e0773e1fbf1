"""MXNET_* environment knobs the port reads (subset of mxnet_tpu/config.py).

Same names and defaults as the JAX package, so one environment configures
both:

  MXNET_DECODE_SLOTS        KV-pool session capacity of a DecodeEngine
  MXNET_DECODE_MAX_LEN      default per-session cache length
  MXNET_DECODE_MAX_NEW      per-request generation budget when omitted
  MXNET_QUANT_DTYPE         weight-only quantization target ("int8"|"fp8")
  MXNET_DEVSTATS            0 disables the device-memory preflight
  MXNET_DEVSTATS_HBM_BYTES  pins the device memory budget the preflight
                            checks against (else the card's total memory)
  MXNET_DEVSTATS_RECOMPILE_LIMIT
                            compiles of one plan past which the recompile
                            sentinel warns (<= 0 disables)
  MXNET_TELEMETRY_PORT      port of the /metrics + /healthz exporter that
                            ``telemetry.start_server()`` binds
  MXNET_SERVING_PORT        the serving frontend's default port (0 or unset:
                            an ephemeral one)
  MXNET_SERVING_REPLICAS    EnginePool replicas a model behind a ModelRouter
  MXNET_SERVING_HBM_BUDGET  device-memory bytes a ModelRouter may fill (else
                            devstats' budget of its device)
  MXNET_SERVING_MAX_MODELS  hot-model table bound (0 = unbounded)
  MXNET_UPDATE_ON_KVSTORE   run the updater inside the kvstore of a
                            several-context Module (default 1)
  MXNET_BACKWARD_DO_MIRROR  activation mirroring in the executor's
                            backward: not ported, so a nonzero value
                            raises at bind instead of being ignored
  MXNET_FUSED_K             Gluon ``fused_fit``'s steps a dispatch when
                            not given (0: the default, 8)
  MXNET_AMP                 1 turns mixed precision on when the package is
                            imported (``amp.init``); 0 leaves every
                            program as it is in fp32
  MXNET_AMP_DTYPE           its compute dtype ("bfloat16" | "float16")
  MXNET_CHECKPOINT_ASYNC    0 makes every ``CheckpointManager.save``
                            blocking (default: a saver thread)
  MXNET_CHECKPOINT_KEEP     keep-last-N retention (<= 0 keeps everything)
  MXNET_CHECKPOINT_BEST_K   also keep the best k commits by metric
  MXNET_CHECKPOINT_SHARDS   shards a commit (<= 0: the visible cards, or
                            1 without one)
  MXNET_CHECKPOINT_RETRIES  retries of a failed shard read or write
  MXNET_CHECKPOINT_BACKOFF_S
                            the first retry's delay in seconds (doubling)
  MXNET_ENGINE_TYPE         NaiveEngine: every imperative op waits for the
                            card before it returns (``engine``)
  MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN
                            ``engine.set_bulk_size`` at import (recorded)
  MXNET_PROFILER_AUTOSTART  1 starts the profiler at import
  MXNET_PROFILER_MODE       recorded (the JAX package's key)
  MXNET_DEVICE_FEED         0 turns the device feed off: every loop stages
                            its batches inline (``pipeline``)
  MXNET_DEVICE_FEED_DEPTH   batches the feeder thread stays ahead
  MXNET_TELEMETRY           0 turns step recording off (watchdog beats
                            stay)
  MXNET_TELEMETRY_LOG       JSONL file the StepLogger appends records to
  MXNET_TELEMETRY_HTTP_LOG  1 keeps the exporter's per-request stderr lines
  MXNET_TELEMETRY_STALL_S   seconds without a step before the watchdog
                            dumps every thread's stack (installed at
                            import when set)
  MXNET_TELEMETRY_STALL_PATH
                            file the watchdog appends its dumps to
  MXNET_TRACE               1 records host-side spans and writes this
                            process's trace-rank-K.json at exit
  MXNET_TRACE_DIR           where the trace shard goes
  MXNET_TRACE_FLUSH_S       seconds between shard snapshots (0: at exit)
  MXNET_TRACE_MAX_EVENTS    bound of the shared chrome-event ring
  MXNET_FLIGHTREC           0 turns the flight recorder off
  MXNET_FLIGHTREC_EVENTS    its ring's size
  MXNET_FLIGHTREC_DIR       where black boxes go; set, it arms the crash
                            triggers and the flusher at import
  MXNET_FLIGHTREC_FLUSH_S   the flusher's interval in seconds
  MXNET_ZERO_STAGE          1|2 makes ``DataParallelTrainer(...)`` build a
                            ``parallel.zero.ZeroTrainer`` (0: plain dp)
  MXNET_ZERO_BUCKET_MB      the ZeRO gradient buckets' size in MB
  MXNET_GRAD_COMPRESS       the ZeRO wire dtype: none | bf16 | fp8 (with
                            an error-feedback residual)
  MXNET_PLAN                the sharding plan ``parallel.make_trainer``
                            builds: auto (the planner's cost model picks)
                            | dp | zero1 | zero2 | dpK.tpT[+zero1|+zero2]
                            | tpT[...]; zero1|zero2 also reroute a plain
                            ``DataParallelTrainer(...)``
  MXNET_PLAN_WIRE_GBPS      the cross-device bandwidth (GB/s) the
                            planner prices collective bytes at
  MXNET_TPU_DISABLE_NATIVE_ITER
                            1 sends every ``ImageRecordIter`` down the
                            Python route (no nvJPEG batch, no assembly
                            kernel)
"""
from __future__ import annotations

import os

_DOCUMENTED = {
    "MXNET_DEVSTATS": 1,
    "MXNET_DEVSTATS_HBM_BYTES": None,
    "MXNET_DEVSTATS_RECOMPILE_LIMIT": 32,
    "MXNET_TELEMETRY_PORT": None,
    "MXNET_SERVING_PORT": None,
    "MXNET_SERVING_REPLICAS": 1,
    "MXNET_SERVING_HBM_BUDGET": None,
    "MXNET_SERVING_MAX_MODELS": 0,
    "MXNET_DECODE_SLOTS": 8,
    "MXNET_DECODE_MAX_LEN": 256,
    "MXNET_DECODE_MAX_NEW": 32,
    "MXNET_QUANT_DTYPE": "int8",
    "MXNET_BACKWARD_DO_MIRROR": 0,
    "MXNET_UPDATE_ON_KVSTORE": 1,
    "MXNET_FUSED_K": 0,
    "MXNET_AMP": 0,
    "MXNET_AMP_DTYPE": "bfloat16",
    "MXNET_CHECKPOINT_ASYNC": 1,
    "MXNET_CHECKPOINT_KEEP": 3,
    "MXNET_CHECKPOINT_BEST_K": 0,
    "MXNET_CHECKPOINT_SHARDS": 0,
    "MXNET_CHECKPOINT_RETRIES": 2,
    "MXNET_CHECKPOINT_BACKOFF_S": "0.5",
    "MXNET_ENGINE_TYPE": "ThreadedEnginePerDevice",
    "MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN": 15,
    "MXNET_PROFILER_AUTOSTART": 0,
    "MXNET_PROFILER_MODE": 0,
    "MXNET_DEVICE_FEED": 1,
    "MXNET_DEVICE_FEED_DEPTH": 2,
    "MXNET_TELEMETRY": 1,
    "MXNET_TELEMETRY_LOG": None,
    "MXNET_TELEMETRY_HTTP_LOG": None,
    "MXNET_TELEMETRY_STALL_S": None,
    "MXNET_TELEMETRY_STALL_PATH": None,
    "MXNET_TRACE": 0,
    "MXNET_TRACE_DIR": None,
    "MXNET_TRACE_FLUSH_S": "0",
    "MXNET_TRACE_MAX_EVENTS": 200000,
    "MXNET_FLIGHTREC": 1,
    "MXNET_FLIGHTREC_EVENTS": 4096,
    "MXNET_FLIGHTREC_DIR": None,
    "MXNET_FLIGHTREC_FLUSH_S": "0.5",
    "MXNET_ZERO_STAGE": 0,
    "MXNET_ZERO_BUCKET_MB": "4",
    "MXNET_GRAD_COMPRESS": "none",
    "MXNET_PLAN": "auto",
    "MXNET_PLAN_WIRE_GBPS": "25",
    "MXNET_TPU_DISABLE_NATIVE_ITER": 0,
}


def get(name, default=None):
    """Read an MXNET_* var with its documented default."""
    if default is None:
        default = _DOCUMENTED.get(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    if isinstance(default, int):
        try:
            return int(raw)
        except ValueError:
            return default
    return raw


def _apply_startup():
    """Honour the variables that act when the package is imported."""
    from . import engine
    engine.set_engine_type(get("MXNET_ENGINE_TYPE"))
    engine.set_bulk_size(get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN"))
    if get("MXNET_AMP"):
        from . import amp
        amp.init(get("MXNET_AMP_DTYPE") or "bfloat16")
    if get("MXNET_PROFILER_AUTOSTART"):
        from . import profiler
        profiler.set_state("run")
    port = get("MXNET_TELEMETRY_PORT")
    if port not in (None, ""):
        from . import telemetry
        try:
            telemetry.start_server(int(port))
        except (ValueError, OSError):
            pass                      # bad port / port in use: no exporter
    if get("MXNET_TELEMETRY_STALL_S") not in (None, ""):
        from .telemetry import watchdog
        watchdog.install()
    if get("MXNET_TRACE"):
        from .telemetry import tracing
        tracing.arm_autodump()
        from . import profiler
        profiler.set_max_events(get("MXNET_TRACE_MAX_EVENTS"))
    if get("MXNET_FLIGHTREC") and get("MXNET_FLIGHTREC_DIR"):
        from .telemetry import flightrec
        flightrec.install()
