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
    if get("MXNET_AMP"):
        from . import amp
        amp.init(get("MXNET_AMP_DTYPE") or "bfloat16")
