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
  MXNET_UPDATE_ON_KVSTORE   run the updater inside the kvstore of a
                            several-context Module (default 1)
  MXNET_BACKWARD_DO_MIRROR  activation mirroring in the executor's
                            backward: not ported, so a nonzero value
                            raises at bind instead of being ignored
"""
from __future__ import annotations

import os

_DOCUMENTED = {
    "MXNET_DEVSTATS": 1,
    "MXNET_DEVSTATS_HBM_BYTES": None,
    "MXNET_DEVSTATS_RECOMPILE_LIMIT": 32,
    "MXNET_TELEMETRY_PORT": None,
    "MXNET_DECODE_SLOTS": 8,
    "MXNET_DECODE_MAX_LEN": 256,
    "MXNET_DECODE_MAX_NEW": 32,
    "MXNET_QUANT_DTYPE": "int8",
    "MXNET_BACKWARD_DO_MIRROR": 0,
    "MXNET_UPDATE_ON_KVSTORE": 1,
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
