"""Telemetry subset of the port (counterpart of mxnet_tpu/telemetry).

  - **registry** (registry.py): Counter/Gauge/Histogram store, host-side
    only; the decode engine registers its series there.
  - **exporter** (exporter.py): stdlib HTTP server; Prometheus text at
    `/metrics`, JSON `/healthz` (`start_server(port)` or
    `MXNET_TELEMETRY_PORT=<port>`).
  - **devstats** (devstats.py): the device-memory preflight, plan
    accounting (each compiled plan's peak and resident bytes) and the
    recompile sentinel.
"""
from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, Registry, counter, gauge,
                       get_registry, histogram)
from .exporter import TelemetryServer, get_server, start_server, stop_server
from . import devstats

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "counter", "gauge",
           "histogram", "get_registry", "TelemetryServer", "start_server",
           "stop_server", "get_server", "devstats"]
