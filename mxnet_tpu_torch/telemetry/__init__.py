"""Telemetry of the port (counterpart of mxnet_tpu/telemetry):

  - **registry** (registry.py): Counter/Gauge/Histogram store, host-side
    only, which also absorbs every ``profiler.register_counter_export``
    hook (serving, device_feed, checkpoint, amp, devstats, embed) and
    exports itself back as the profiler's "telemetry" hook.
  - **exporter** (exporter.py): stdlib HTTP server; Prometheus text at
    ``/metrics``, JSON ``/healthz`` (``start_server(port)`` or
    ``MXNET_TELEMETRY_PORT=<port>``).
  - **step telemetry** (steplog.py): ``StepLogger`` threaded through
    ``BaseModule.fit`` / ``Module._fit_fused`` / Gluon ``fused_fit``; JSONL
    records with ``MXNET_TELEMETRY_LOG=<path>``; ``MXNET_TELEMETRY=0``
    records nothing.
  - **hang diagnostics** (watchdog.py): the stall watchdog
    (``MXNET_TELEMETRY_STALL_S``), SIGUSR1 dumps and deadline dumps.
  - **span tracing** (tracing.py): ``MXNET_TRACE=1`` host-side spans over
    the feed / compute / comm / ckpt / serve phases, ``trace-rank-K.json``
    shards and ``--merge``.
  - **flight recorder** (flightrec.py): the always-on ring of recent
    spans and events, dumped on an uncaught exception, SIGTERM or a
    watchdog stall.
  - **devstats** (devstats.py): the device-memory preflight, plan
    accounting (each compiled plan's peak and resident bytes) and the
    recompile sentinel.

Selftest: ``python -m mxnet_tpu_torch.telemetry --selftest``.
"""
from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, Registry, counter, gauge,
                       get_registry, histogram)
from .exporter import TelemetryServer, get_server, start_server, stop_server
from .steplog import StepLogger, enabled, log_event, maybe_step_logger
from . import watchdog
from . import tracing
from . import flightrec
from . import devstats
from .watchdog import install as install_watchdog
from .tracing import span, traced

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "counter", "gauge",
           "histogram", "get_registry", "TelemetryServer", "start_server",
           "stop_server", "get_server", "StepLogger", "maybe_step_logger",
           "enabled", "log_event", "watchdog", "install_watchdog",
           "tracing", "flightrec", "devstats", "span", "traced"]
