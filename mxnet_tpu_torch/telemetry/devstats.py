"""Device-memory preflight, plan accounting and the recompile sentinel
(subset of mxnet_tpu/telemetry/devstats.py).

* **Preflight**: a KV pool plus weights, or a plan, that cannot fit the
  card fails with a sized error (:class:`HBMPreflightError`) instead of
  running out of memory mid-request.
* **Plan accounting** (:func:`record_program`, :func:`program_stats`,
  :func:`counters`): each compiled plan (the decode engine's CUDA graphs)
  records its name, kind, peak bytes (the caching allocator's peak across
  its capture) and resident bytes (what its capture added to the graphs'
  memory pool).
* **Recompile sentinel** (:func:`note_compile`): compiles per plan, and a
  warning once one plan passes ``MXNET_DEVSTATS_RECOMPILE_LIMIT``.

The JAX package also records each program's FLOPs and bytes accessed from
XLA's cost analysis. A CUDA graph carries no such analysis and PyTorch
offers none for eager kernels, so those fields are absent here until the
port has a source for them.
"""
from __future__ import annotations

import logging
import os
import threading

from .. import config
from .registry import counter as _counter

__all__ = ["HBMPreflightError", "enabled", "hbm_budget", "preflight",
           "pool_bytes", "record_program", "program_stats", "note_compile",
           "counters", "recompile_limit"]

log = logging.getLogger("mxnet_tpu_torch.devstats")

_LOCK = threading.RLock()
_PROGRAMS = {}       # name -> stats dict (peak/resident bytes + "kind")
_COMPILES = {}       # name -> compiles observed (sentinel input)
_STORMED = set()     # programs whose storm already fired
_STORMS = [0]


class HBMPreflightError(RuntimeError):
    """An estimated device-memory footprint exceeds the budget. Raised
    before anything is allocated, with sizes in the message."""


def enabled():
    """Live MXNET_DEVSTATS flag (default on; ``0`` is fully inert)."""
    return bool(config.get("MXNET_DEVSTATS"))


def recompile_limit():
    """Sentinel threshold: compiles of one plan past this warn
    (``MXNET_DEVSTATS_RECOMPILE_LIMIT``, <= 0 disables)."""
    return int(config.get("MXNET_DEVSTATS_RECOMPILE_LIMIT"))


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


def preflight(name, need_bytes, resident_bytes=0, budget=None, what="plan",
              device=None):
    """Check an estimated footprint (``need_bytes`` on top of
    ``resident_bytes`` already held) against the budget (``budget``, else
    that of ``device``). Returns headroom bytes (None when no budget is
    known); raises :class:`HBMPreflightError` when it does not fit."""
    if budget is None:
        budget = hbm_budget(device)
    if budget is None:
        return None
    total = int(need_bytes) + int(resident_bytes)
    if total > budget:
        raise HBMPreflightError(
            "HBM preflight: %s %r needs %s (estimated peak %s + %s "
            "already resident) but the device memory budget is %s — "
            "over by %s. Shrink the batch/bucket, evict cached plans, "
            "or raise MXNET_DEVSTATS_HBM_BYTES if the budget is wrong."
            % (what, name, _mib(total), _mib(need_bytes),
               _mib(resident_bytes), _mib(budget), _mib(total - budget)))
    return budget - total


# -- plan accounting ----------------------------------------------------------

def pool_bytes(pool, device):
    """Bytes of the segments a CUDA graph memory pool holds on
    ``device`` (``torch.cuda.memory_snapshot``)."""
    import torch
    pid = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == pid)


def capture_mark(pool, device):
    """(bytes allocated on ``device``, bytes of ``pool``'s segments) now.
    Taken before a CUDA graph capture into ``pool`` and passed to
    ``capture_peak`` after it: the capture's peak without resetting the
    process's peak counters (a caller's own measurement)."""
    import torch
    return torch.cuda.memory_allocated(device), pool_bytes(pool, device)


def capture_peak(pool, device, mark):
    """The peak bytes of a capture into ``pool`` since ``mark``
    (``capture_mark``): the bytes allocated before it plus the segments it
    added to the pool, which hold every block it allocated (the caching
    allocator's rounding makes this an upper bound)."""
    allocated, held = mark
    return allocated + pool_bytes(pool, device) - held


def record_program(name, stats, kind="program"):
    """Record one plan's stats (``peak_bytes``, ``resident_bytes``) under
    ``name``; returns them. Last write wins."""
    with _LOCK:
        _PROGRAMS[name] = dict(stats, kind=kind)
    return stats


def program_stats(name=None):
    """Snapshot of recorded plan stats (one dict, or all)."""
    with _LOCK:
        if name is not None:
            s = _PROGRAMS.get(name)
            return dict(s) if s else None
        return {k: dict(v) for k, v in _PROGRAMS.items()}


def _rec_counter():
    return _counter("mxnet_recompiles_total",
                    "plan compiles (graph captures) noted by devstats")


def note_compile(name, n=1):
    """Count ``n`` compiles of plan ``name``; warn once when the plan's
    total crosses :func:`recompile_limit`."""
    if n <= 0:
        return
    _rec_counter().inc(n)
    limit = recompile_limit()
    storm = False
    with _LOCK:
        c = _COMPILES.get(name, 0) + n
        _COMPILES[name] = c
        if 0 < limit < c and name not in _STORMED:
            _STORMED.add(name)
            _STORMS[0] += 1
            storm = True
    if storm:
        log.warning(
            "devstats: recompile storm — plan %r compiled %d times "
            "(limit %d). Shape churn is defeating the plan cache; pad or "
            "bucket inputs. (MXNET_DEVSTATS_RECOMPILE_LIMIT)",
            name, c, limit)


def counters():
    """Plan accounting as one dict: plan count, storms, the budget,
    compiles by plan, and ``peak_bytes`` / ``resident_bytes`` by plan."""
    with _LOCK:
        progs = {k: dict(v) for k, v in _PROGRAMS.items()}
        compiles = dict(_COMPILES)
        storms = _STORMS[0]
    out = {"programs": len(progs), "recompile_storms": storms,
           "hbm_budget_bytes": hbm_budget() or 0, "recompiles": compiles}
    for stat in ("peak_bytes", "resident_bytes"):
        series = {n: s.get(stat, 0) for n, s in progs.items()}
        if series:
            out[stat] = series
    return out

