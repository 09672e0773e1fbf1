"""Device-memory preflight (subset of mxnet_tpu/telemetry/devstats.py).

Only the admission check carries over: a KV pool plus weights that cannot
fit the card fails at construction with a sized error instead of running
out of memory mid-request. XLA cost analysis and plan accounting have no
counterpart yet.
"""
from __future__ import annotations

import os

from .. import config

__all__ = ["HBMPreflightError", "enabled", "hbm_budget", "preflight"]


class HBMPreflightError(RuntimeError):
    """An estimated device-memory footprint exceeds the budget. Raised
    before anything is allocated, with sizes in the message."""


def enabled():
    """Live MXNET_DEVSTATS flag (default on; ``0`` is fully inert)."""
    return bool(config.get("MXNET_DEVSTATS"))


def hbm_budget(device=None):
    """Device memory budget in bytes: ``MXNET_DEVSTATS_HBM_BYTES`` if set,
    else the card's total memory (``torch.cuda.mem_get_info``); None on
    the CPU (preflight inert)."""
    raw = os.environ.get("MXNET_DEVSTATS_HBM_BYTES")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    import torch
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(torch.device(device))[1])


def _mib(n):
    n = float(n)
    for unit, width in (("GiB", 1024.0 ** 3), ("MiB", 1024.0 ** 2),
                        ("KiB", 1024.0)):
        if abs(n) >= width:
            return "%.1f %s" % (n / width, unit)
    return "%d B" % int(n)


def preflight(name, need_bytes, what="plan", device=None):
    """Check an estimated footprint against the budget of ``device``
    *before* allocating. Returns headroom bytes (None when no budget is
    known); raises :class:`HBMPreflightError` when it does not fit."""
    budget = hbm_budget(device)
    if budget is None:
        return None
    need = int(need_bytes)
    if need > budget:
        raise HBMPreflightError(
            "HBM preflight: %s %r needs %s but the device memory budget "
            "is %s — over by %s. Shrink the pool, or raise "
            "MXNET_DEVSTATS_HBM_BYTES if the budget is wrong."
            % (what, name, _mib(need), _mib(budget), _mib(need - budget)))
    return budget - need
